"""The share of the session's polls that found no fresh state, over every
poll of the window: the session sends no command on such a poll and waits
a period. The plant answers a command in lockstep, so a poll is stale
where the tick before it ended just short of the period's deadline and
the plant's answer had not yet come; a tick that overruns sleeps to the
next deadline and polls no stale state. A stale poll fails no
operation, so `failed` leaves it out."""


def read(record):
    sent, stale = record.get("sent"), record.get("stale")
    if not sent:
        return None
    return 100.0 * stale / (sent + stale)
