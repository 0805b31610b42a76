"""Rollout sampling and export of the port (port of ``placement_tpu/viz``)."""
