"""Environment parameters (the batched stepper is not ported yet)."""

from placement_tpu_torch.env.types import EnvParams, Variant  # noqa: F401
