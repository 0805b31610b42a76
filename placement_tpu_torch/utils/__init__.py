"""Config, checkpoints, metrics and profiling of the port."""
