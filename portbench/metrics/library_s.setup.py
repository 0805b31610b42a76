"""Seconds of the kernel library's build or load, the part of ``setup_s``
that the program's span ``fused_rollout.library`` covers: nvcc on a
checkout's first run, else the sources' hash, ``ctypes.CDLL`` and the
capacity check (the program's own clock,
``fused_rollout.library_seconds()``). None where the program keeps no such
reading."""


def read(record):
    from placement_tpu_torch.ops import fused_rollout

    seconds = getattr(fused_rollout, "library_seconds", None)
    return None if seconds is None else seconds()
