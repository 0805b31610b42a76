"""Device milliseconds a chunk that the beam route costs over the centroid
route: the chunk's kernels' time (as ``kernel_ms.rollout`` reads it) less
that of the same chunks run under the centroid reward, which the
``fused_wide_beam`` engine's profiled window adds to the trace as
``centroid``. Placement and regeneration do not depend on the reward."""

from portbench import manifest


def read(record):
    trace = record.get("trace")
    if not trace or not trace.get("centroid"):
        return None
    kernel_ms = manifest.reader("kernel_ms.rollout")
    beam = kernel_ms(record)
    centroid = kernel_ms({"trace": trace["centroid"]})
    if beam is None or centroid is None:
        return None
    return beam - centroid
