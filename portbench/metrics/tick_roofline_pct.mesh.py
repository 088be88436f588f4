"""The tick's roofline share on rank 0's card: ``tick_roofline_pct.batch``
for the card's scenarios (portbench/work.py, the published peaks) over
the device time of rank 0's kernels in the traced window a tick, NCCL's
collective kernels left out (they wait for the peers), in percent."""

from portbench.run import load_module

_batch = load_module("metrics", "tick_roofline_pct.batch")


def read(record):
    device = [e for e in record.get("device") or ()
              if not e[0].startswith("nccl")]
    return _batch.read({**record, "device": device})
