"""The median latency of the solving ticks (one in five at mpc_step 5,
the tail above the 80th percentile of all ticks): the benchmark's stamps
from state receipt to command handed to the wire, over every solving tick
of the window."""

import statistics


def read(record):
    xs = record.get("solve_ms")
    return statistics.median(xs) if xs else None
