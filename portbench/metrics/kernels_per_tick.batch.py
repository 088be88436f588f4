"""Kernels a tick: the device kernels in the traced window over the ticks
in it (torch.profiler; copies and fills left out). An exact count."""

from portbench import trace


def read(record):
    ticks = record.get("ticks")
    if not ticks or not record.get("device"):
        return None
    n = sum(1 for name, _, _ in record["device"] if trace.is_kernel(name))
    return n / ticks
