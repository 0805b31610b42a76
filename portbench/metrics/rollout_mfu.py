"""The whole chunk's share of the card's peak: the frozen work model's
least time for a chunk over the profiled window's wall time a chunk. It
bounds a kernel's share from above whatever kernels run the chunk."""


def read(record):
    trace = record.get("trace")
    if not trace:
        return None
    per_chunk_ms = trace["window_s"] * 1e3 / trace["chunks"]
    return 100.0 * trace["bound"]["ms"] / per_chunk_ms
