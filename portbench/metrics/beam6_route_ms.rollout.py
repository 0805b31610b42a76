"""Device milliseconds a chunk that the beam route of six beams costs over
the centroid route: ``beam_route_ms.rollout``'s reading (the chunk's
kernel time less that of the same chunks under the centroid reward, the
profiled window's second reading) on the cells whose beam route runs the
wide6 instantiation."""

from portbench import manifest


def read(record):
    return manifest.reader("beam_route_ms.rollout")(record)
