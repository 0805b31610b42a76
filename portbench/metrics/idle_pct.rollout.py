"""The share of the profiled window in which nothing ran on the card: one
less the union of the device activities over the window's length."""


def read(record):
    trace = record.get("trace")
    if not trace:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
