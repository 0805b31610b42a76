"""configs/*.json -> EnvParams (port of ``placement_tpu/utils/config.py``).

Reads the same JSON files as the JAX package (the reference's
``agent/config/*.json`` schema). Only the ``env_config`` half is ported:
the ``ModelConfig`` half waits for the port of the model zoo.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

from placement_tpu_torch.env.types import EnvParams, Variant

_VARIANTS = {
    "square": Variant.SQUARE,
    "rectangle": Variant.RECT,
    "rectangle_pin": Variant.PIN,
    "rectangle_spatial_pin": Variant.PIN_SPATIAL,
}

# model-type string -> (env variant, config basename); mirrors
# model_dict/model_json_dict (utils/agent/utils.py:62-86)
MODEL_TYPES: Dict[str, Tuple[str, str]] = {
    "square": ("square", "square_model.json"),
    "rectangle": ("rectangle", "rectangle_model.json"),
    "rectangle_factorized": ("rectangle", "rectangle_model_factorized.json"),
    "rectangle_pin": ("rectangle_pin", "rectangle_pin_model.json"),
    "rectangle_pin_attn_component": (
        "rectangle_pin", "rectangle_pin_attn_component_model.json"),
    "rectangle_pin_attn_all": (
        "rectangle_pin", "rectangle_pin_attn_component_pin_model.json"),
    "rectangle_factorized_pin": (
        "rectangle_pin", "rectangle_pin_factorized_model.json"),
    "rectangle_pin_all_attn_factorized": (
        "rectangle_pin", "rectangle_pin_all_attn_factorized_model.json"),
    "rectangle_pin_attn_all_no_grid": (
        "rectangle_pin", "rectangle_pin_attn_all_no_grid_model.json"),
    "rectangle_spatial_pin": (
        "rectangle_spatial_pin", "rectangle_pin_spatial_model.json"),
}

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "configs")

_ENV_FIELDS = {f.name for f in dataclasses.fields(EnvParams)}


def env_params_from_config(env_config: Dict[str, Any]) -> EnvParams:
    """env_config dict (reference schema) -> EnvParams."""
    cfg = dict(env_config)
    env_type = cfg.pop("type", "rectangle_pin")
    variant = _VARIANTS[env_type]
    kw = {k: v for k, v in cfg.items() if k in _ENV_FIELDS}
    return EnvParams(variant=variant, **kw).validate()


def load_env_params(model_type: str,
                    config_dir: Optional[str] = None) -> EnvParams:
    """model type -> EnvParams from ``configs/`` (the env half of the JAX
    package's ``load_experiment``)."""
    _, basename = MODEL_TYPES[model_type]
    path = os.path.join(config_dir or CONFIG_DIR, basename)
    with open(path) as f:
        raw = json.load(f)
    return env_params_from_config(raw["env_config"])
