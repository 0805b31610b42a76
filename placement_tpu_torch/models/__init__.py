"""The policy-network zoo of the port (port of ``placement_tpu/models``)."""

from placement_tpu_torch.models.zoo import (  # noqa: F401
    MODEL_REGISTRY,
    ModelConfig,
    build_model,
)
