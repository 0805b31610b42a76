"""The benchmark of ``placement_tpu_torch``: ``python -m portbench.run``."""
