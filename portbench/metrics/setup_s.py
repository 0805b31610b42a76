"""Seconds from the harness's start to the first timed chunk: imports, the
card's context, the kernel library's build or load, and the cell's warm-up
(host clock)."""


def read(record):
    return record.get("setup_s")
