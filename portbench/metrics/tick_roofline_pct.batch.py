"""The tick's roofline share: the least time of the window's tick work at
the cell's sizes (portbench/work.py, the published peaks; a dtMPC window
weighted one solving tick to mpc_every - 1 held ones) over the device time
of all kernels in the window a tick, in percent. Splitting or fusing
kernels leaves the numerator as it is."""

from portbench import trace


def read(record):
    ticks, bound = record.get("ticks"), record.get("bound_ms_per_tick")
    if not ticks or bound is None:
        return None
    kernel_us = sum(e - s for name, s, e in record["device"]
                    if trace.is_kernel(name))
    if kernel_us <= 0.0:
        return None
    return 100.0 * bound / (kernel_us * 1e-3 / ticks)
