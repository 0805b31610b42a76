"""Multi-process scale-out (port of ``placement_tpu/parallel/``)."""
