"""The placement environments: parameters, the batched stepper, the pooled
auto-reset engine and the gym-style adapter."""

from placement_tpu_torch.env.types import EnvParams, Variant  # noqa: F401
