"""Host time inside a session tick: the share of the time inside the
traced ticks' spans (state receipt to command handed to the wire) in which
no device operation runs, in percent. The rate's sleep between ticks is
not counted."""

from portbench import trace


def read(record):
    spans = record.get("spans")
    if not spans or not record.get("device"):
        return None
    dev = [(s, e) for _, s, e in record["device"]]
    total = sum(e - s for s, e in spans)
    if total <= 0.0:
        return None
    busy = 0.0
    # the device intervals sorted once; each span clips its own
    merged = trace.merge(dev)
    import bisect
    starts = [s for s, _ in merged]
    for lo, hi in spans:
        i = max(0, bisect.bisect_right(starts, lo) - 1)
        while i < len(merged) and merged[i][0] < hi:
            s, e = merged[i]
            busy += max(0.0, min(e, hi) - max(s, lo))
            i += 1
    return 100.0 * (1.0 - busy / total)
