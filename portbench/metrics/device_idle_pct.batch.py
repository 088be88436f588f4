"""The device's idle share of the traced window: the part of the window
that no device operation covers (the union of their intervals), in
percent."""

from portbench import trace


def read(record):
    if "ticks" not in record or not record.get("device"):
        return None
    lo, hi = record["window"]
    return 100.0 * (1.0 - trace.busy_us(record) / (hi - lo))
