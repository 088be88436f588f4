"""The median latency of the held-force ticks (four in five at mpc_step
5): the benchmark's stamps from state receipt to command handed to the
wire, over every held tick of the window."""

import statistics


def read(record):
    xs = record.get("hold_ms")
    return statistics.median(xs) if xs else None
