"""configs/*.json -> (EnvParams, ModelConfig) (port of
``placement_tpu/utils/config.py``).

Reads the same JSON files as the JAX package (the reference's
``agent/config/*.json`` schema): an ``env_config`` block maps onto
``EnvParams`` and a ``model.custom_model_config`` block onto
``ModelConfig``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

from placement_tpu_torch.env.types import EnvParams, Variant
from placement_tpu_torch.models.zoo import ModelConfig

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
_MODEL_FIELDS = {f.name for f in dataclasses.fields(ModelConfig)}


def env_params_from_config(env_config: Dict[str, Any]) -> EnvParams:
    """env_config dict (reference schema) -> EnvParams."""
    cfg = dict(env_config)
    env_type = cfg.pop("type", "rectangle_pin")
    variant = _VARIANTS[env_type]
    kw = {k: v for k, v in cfg.items() if k in _ENV_FIELDS}
    return EnvParams(variant=variant, **kw).validate()


def model_config_from_config(model_type: str, env_params: EnvParams,
                             custom: Dict[str, Any]) -> ModelConfig:
    """custom_model_config dict -> ModelConfig; the sizes the env fixes
    come from ``env_params`` (``agent/policy.py::model_config_for``)."""
    from placement_tpu_torch.agent.policy import model_config_for
    kw = {k: v for k, v in custom.items() if k in _MODEL_FIELDS
          and k not in ("model_type", "height", "width",
                        "max_num_components", "max_num_nets",
                        "max_num_pins_per_component",
                        "component_feature_vector_width",
                        "pin_feature_vector_width")}
    return model_config_for(env_params, model_type, **kw)


def _raw(model_type: str, config_dir: Optional[str]) -> Dict[str, Any]:
    _, basename = MODEL_TYPES[model_type]
    with open(os.path.join(config_dir or CONFIG_DIR, basename)) as f:
        return json.load(f)


def load_env_params(model_type: str,
                    config_dir: Optional[str] = None) -> EnvParams:
    """model type -> EnvParams from ``configs/`` (the env half of
    ``load_experiment``)."""
    return env_params_from_config(_raw(model_type, config_dir)["env_config"])


def load_experiment(model_type: str,
                    config_dir: Optional[str] = None
                    ) -> Tuple[EnvParams, ModelConfig, Dict[str, Any]]:
    """model type -> (EnvParams, ModelConfig, raw json) from ``configs/``."""
    raw = _raw(model_type, config_dir)
    env_params = env_params_from_config(raw["env_config"])
    model_cfg = model_config_from_config(
        model_type, env_params, raw["model"]["custom_model_config"])
    return env_params, model_cfg, raw


def save_config(path: str, env_params: EnvParams,
                model_cfg: ModelConfig) -> None:
    """Write the run config as JSON, in the JAX package's layout."""
    payload = {
        "env_config": {**dataclasses.asdict(env_params),
                       "variant": int(env_params.variant)},
        "model_config": dataclasses.asdict(model_cfg),
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
