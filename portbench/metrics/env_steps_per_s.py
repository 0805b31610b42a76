"""Environment steps completed a second: boards x steps x chunks of the
timed window over the window's wall time, which ends with the fetch that
waits for every chunk (host clock)."""


def read(record):
    window = record.get("window")
    if not window:
        return None
    return window["env_steps"] / window["seconds"]
