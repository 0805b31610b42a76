"""The chunk's kernels' share of their roofline: the frozen work model's
least time for the chunk (``workmodel.chunk_bound``, bytes or operations,
whichever bounds) over the kernels' device time a chunk."""

from portbench import manifest


def read(record):
    trace = record.get("trace")
    kernel_ms = manifest.reader("kernel_ms.rollout")(record)
    if not trace or not kernel_ms:
        return None
    return 100.0 * trace["bound"]["ms"] / kernel_ms
