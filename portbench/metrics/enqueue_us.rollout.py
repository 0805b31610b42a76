"""Host microseconds of one ``FusedRollout.per_board`` call, with no sync:
the mean over bursts enqueued while the card sleeps, so the launch queue
never pushes back (host clock)."""


def read(record):
    trace = record.get("trace")
    return None if not trace else trace.get("enqueue_us")
