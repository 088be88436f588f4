"""The median device time of the mesh's reduction on rank 0, in ms: the
statistics' reduction and their collectives (``all_reduce`` over NCCL)
on rank 0's stream, between two timing events, over the window's chunks
before the first profiled one (a profiled process stays slower). With one
process a card it includes rank 0's wait at the collectives for the
slowest peer.

Read from the port's mesh log (``utils.profiling.mesh_log``), which the
driver gathers from every rank at the window's end (``mesh_ranks``).
None where the port keeps no such log."""

import math
import statistics


def read(record):
    ranks = record.get("mesh_ranks")
    if not ranks:
        return None
    r0 = ranks[0]
    n = r0["profiled"].index(True) if True in r0["profiled"] \
        else len(r0["profiled"])
    ms = [x for x in r0["reduce_ms"][:n] if not math.isnan(x)]
    return statistics.median(ms) if ms else None
