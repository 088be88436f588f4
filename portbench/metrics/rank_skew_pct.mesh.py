"""How far the slowest rank trails the fastest: the largest of the ranks'
median rollout device times (each rank's shard, between two timing events
on its stream, over the window's chunks before rank 0's first profiled
one) over the smallest, minus 1, in percent. Every chunk waits at its
collectives for the slowest rank.

Read from the port's mesh logs (``utils.profiling.mesh_log``), which the
driver gathers from every rank at the window's end (``mesh_ranks``; every
rank makes the same calls in the same order). None where the port keeps
no such log or a rank timed nothing."""

import math
import statistics


def read(record):
    ranks = record.get("mesh_ranks")
    if not ranks or len(ranks) < 2:
        return None
    r0 = ranks[0]
    n = r0["profiled"].index(True) if True in r0["profiled"] \
        else len(r0["profiled"])
    medians = []
    for r in ranks:
        ms = [x for x in r["rollout_ms"][:n] if not math.isnan(x)]
        if not ms:
            return None
        medians.append(statistics.median(ms))
    if min(medians) <= 0.0:
        return None
    return 100.0 * (max(medians) / min(medians) - 1.0)
