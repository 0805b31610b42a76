"""The ten reference policy architectures as one configurable module (port of
``placement_tpu/models/zoo.py``).

Presets (registry names match utils/agent/utils.py:62-74):

  square                              SquareModel (square_model.py:14)
  rectangle                           RectangleModel (rectangle_model.py:13)
  rectangle_factorized                RectangleFactorizedModel
  rectangle_pin                       RectanglePinModel
  rectangle_pin_attn_component        RectanglePinAttnCompModel
  rectangle_pin_attn_all              RectanglePinAttnCompPinModel
  rectangle_factorized_pin            RectanglePinFactorizedModel
  rectangle_pin_all_attn_factorized   RectanglePinAllAttnFactorized
  rectangle_pin_attn_all_no_grid      RectanglePinAttnAllNoGridModel
  rectangle_spatial_pin               RectanglePinSpatialModel

Observations arrive batched [B, ...] in the JAX obs-dict layout (NHWC
grids, pin features [B, C, ppc, F]). Joint-head presets return masked
logits over the flattened (orientation, x, y) action space plus a value;
factorized presets return the encoding plus a value, with the per-factor
heads ``o_logits`` / ``x_logits`` / ``y_logits``.

Flax infers every layer's input width at ``init``; here each width is
computed from the config, and for the spatial preset's component-grid
encoder from the env's largest component (``component_hw``), which the
config does not carry. A submodule exists only where its preset uses
it, under the Flax module's name, so the carried parameters map one to
one (``models/convert.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from placement_tpu_torch.models.blocks import (
    BatchNorm, ConvBlocks, SelfAttention, mask_logits)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Union of the reference's custom_model_config fields
    (agent/config/*.json); copied field for field from the JAX package."""

    model_type: str = "rectangle_pin"
    height: int = 10
    width: int = 10
    num_orientations: int = 4
    max_num_components: int = 5
    max_num_nets: int = 3
    max_num_pins_per_component: int = 4
    component_feature_vector_width: int = 5
    pin_feature_vector_width: int = 8
    num_conv_blocks: int = 2
    num_conv_filters: int = 3
    conv_kernel_size: int = 3
    activation: str = "relu"
    max_pool: bool = False
    max_pool_kernel_size: int = 2
    component_feature_encoding_dimension: int = 16
    pin_feature_encoding_dimension: int = 16
    attn_hidden_size: int = 16
    attn_hidden_size_pin: int = 16
    # spatial-model extras (rectangle_pin_spatial_model config)
    num_conv_blocks_component_grid: int = 1
    num_conv_filters_component_grid: int = 3
    conv_kernel_size_component_grid: int = 3
    activation_component_grid: str = "relu"
    max_pool_component_grid: bool = False
    max_pool_kernel_size_component_grid: int = 3
    conv_padding_component_grid: str = "SAME"
    component_attn_hidden_size: int = 16
    # factorized extras
    factorization: str = "orientation"  # "orientation" | "coordinates"
    use_batch_norm: bool = True

    @property
    def is_factorized(self) -> bool:
        return self.model_type in ("rectangle_factorized",
                                   "rectangle_factorized_pin",
                                   "rectangle_pin_all_attn_factorized")

    @property
    def num_actions(self) -> int:
        if self.model_type == "square":
            return self.height * self.width
        return self.num_orientations * self.height * self.width


MODEL_REGISTRY = (
    "square", "rectangle", "rectangle_factorized", "rectangle_pin",
    "rectangle_pin_attn_component", "rectangle_pin_attn_all",
    "rectangle_factorized_pin", "rectangle_pin_all_attn_factorized",
    "rectangle_pin_attn_all_no_grid", "rectangle_spatial_pin")

_PIN_ATTN_ALL = ("rectangle_pin_attn_all", "rectangle_pin_attn_all_no_grid",
                 "rectangle_pin_all_attn_factorized")
_COMP_ATTN = ("rectangle_pin_attn_component",) + _PIN_ATTN_ALL


def _one_hot(x: torch.Tensor, n: int) -> torch.Tensor:
    """jax.nn.one_hot of the truncated values: an index outside [0, n) is
    all zeros."""
    idx = x.to(torch.int32)
    return (idx[..., None] == torch.arange(n, device=x.device)).to(F32)


class PlacementModel(nn.Module):
    """One module, ten presets: the encoder is chosen by cfg.model_type.

    ``component_hw`` = (max_component_h, max_component_w) of the env: the
    sides of the spatial preset's component grid (``Policy`` passes its
    env's; see ``_component_grid_width``)."""

    def __init__(self, cfg: ModelConfig,
                 component_hw: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.cfg = cfg
        t = cfg.model_type
        enc = 0
        if t != "rectangle_pin_attn_all_no_grid":
            self.grid_conv = self._conv(1, "")
            enc += self._conv_width(self.grid_conv, cfg.height, cfg.width)

        if t in ("rectangle", "rectangle_factorized"):
            self.flat_feature_dense = nn.Linear(
                cfg.max_num_components * cfg.component_feature_vector_width,
                cfg.component_feature_encoding_dimension)
            self.flat_feature_norm = BatchNorm(
                cfg.component_feature_encoding_dimension)
            enc += cfg.component_feature_encoding_dimension

        if t.startswith("rectangle_pin") and t != "rectangle_spatial_pin" \
                or t == "rectangle_factorized_pin":
            e_pin = cfg.pin_feature_encoding_dimension
            self.component_dense = nn.Linear(
                cfg.component_feature_vector_width,
                cfg.component_feature_encoding_dimension)
            self.pin_dense = nn.Linear(4 + cfg.max_num_nets + 1, e_pin)
            if t in _PIN_ATTN_ALL:
                a = cfg.attn_hidden_size_pin
                self.pin_q = nn.Linear(e_pin, a)
                self.pin_k = nn.Linear(e_pin, a)
                self.pin_v = nn.Linear(e_pin, a)
                pooled = cfg.max_num_pins_per_component * a
            else:
                pooled = e_pin
            token = cfg.component_feature_encoding_dimension + pooled + 4
            if t in _COMP_ATTN:
                self.comp_attn = SelfAttention(token, cfg.attn_hidden_size)
                token = cfg.attn_hidden_size
            enc += cfg.max_num_components * token

        if t == "rectangle_spatial_pin":
            self.pin_grid_conv = self._conv(cfg.max_num_nets + 1, "")
            enc += self._conv_width(self.pin_grid_conv, cfg.height, cfg.width)
            self.component_grid_conv = self._conv(cfg.max_num_nets + 1,
                                                  "_component_grid")
            token = self._component_grid_width(component_hw) + 4
            self.spatial_comp_attn = SelfAttention(
                token, cfg.component_attn_hidden_size)
            enc += cfg.max_num_components * cfg.component_attn_hidden_size

        self.encoding_size = enc
        if cfg.is_factorized:
            o, coord = cfg.num_orientations, cfg.factorization != "orientation"
            self.orientation_head = nn.Linear(enc + (2 if coord else 0), o)
            self.x_head = nn.Linear(enc + (0 if coord else o), cfg.height)
            self.y_head = nn.Linear(enc + (1 if coord else o + 1), cfg.width)
        else:
            self.logits_head = nn.Linear(enc, cfg.num_actions)
        self.value_head = nn.Linear(enc, 1)

    def _conv(self, in_channels: int, suffix: str) -> ConvBlocks:
        """The grid encoder (suffix "") or the spatial model's component-grid
        encoder (suffix "_component_grid"), from the config's fields."""
        cfg = self.cfg
        get = lambda name: getattr(cfg, name + suffix)  # noqa: E731
        padding = (cfg.conv_padding_component_grid.upper() if suffix
                   else "VALID")
        return ConvBlocks(in_channels, get("num_conv_blocks"),
                          get("num_conv_filters"), get("conv_kernel_size"),
                          get("activation"), get("max_pool"),
                          get("max_pool_kernel_size"), padding=padding,
                          use_batch_norm=cfg.use_batch_norm)

    def _component_grid_width(self, component_hw: Optional[Tuple[int, int]]
                              ) -> int:
        """Width of one component's encoded grid, as Flax infers it: the
        max_h x max_w grid (``component_hw``) through the component-grid
        encoder's padding and pool. Without ``component_hw`` only a "SAME"
        encoder without pooling, which keeps every cell, has a width the
        config fixes (max_num_pins_per_component = max_h * max_w cells, as
        every shipped config has it); other settings raise."""
        cfg, conv = self.cfg, self.component_grid_conv
        if component_hw is not None:
            return self._conv_width(conv, *component_hw)
        if conv.padding != "SAME" or conv.max_pool:
            raise ValueError(
                "the component-grid encoder's width needs the component "
                "sides: pass component_hw=(max_component_h, max_component_w)")
        return cfg.max_num_pins_per_component * conv.out_channels

    @staticmethod
    def _conv_width(conv: ConvBlocks, h: int, w: int) -> int:
        oh, ow = conv.out_hw(h, w)
        return oh * ow * conv.out_channels

    # -- encoders ----------------------------------------------------------

    def _encode_grid(self, grid: torch.Tensor) -> torch.Tensor:
        x = self.grid_conv(grid)                     # NHWC
        return x.reshape(x.shape[0], -1)

    def _encode_rect_features(self, obs: Dict[str, torch.Tensor]
                              ) -> torch.Tensor:
        """Zero the placed components, flatten, Dense + BN + relu
        (rectangle_model.py:104-163)."""
        feat = obs["all_components_feature"]
        keep = (obs["placement_mask"] == 0).to(feat.dtype)
        x = (feat * keep[..., None]).reshape(feat.shape[0], -1)
        return torch.relu(self.flat_feature_norm(self.flat_feature_dense(x)))

    def _pin_tokens(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Numeric pin features and the one-hot net id
        (rectangle_pin_model.py:234-287) -> [B, C, ppc, 4 + nets + 1]."""
        num = obs["all_pins_num_feature"]
        onehot = _one_hot(obs["all_pins_cat_feature"][..., 0],
                          self.cfg.max_num_nets + 1)
        return torch.cat([num, onehot], dim=-1)

    def _encode_pin_components(self, obs: Dict[str, torch.Tensor]
                               ) -> torch.Tensor:
        """The pin models' component tokens [B, C, D]
        (rectangle_pin_model.py:132-232)."""
        t = self.cfg.model_type
        comp_enc = self.component_dense(obs["all_components_feature"])
        pin_enc = self.pin_dense(self._pin_tokens(obs))    # [B, C, ppc, E]
        if t in _PIN_ATTN_ALL:
            # per-component pin self-attention, flattened
            # (rectangle_pin_attn_component_pin_model.py:120-171)
            q, k, v = self.pin_q(pin_enc), self.pin_k(pin_enc), \
                self.pin_v(pin_enc)
            w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
            att = torch.relu(w @ v)
            pin_pooled = att.reshape(att.shape[0], att.shape[1], -1)
        else:
            pin_pooled = pin_enc.sum(dim=2)     # shared dense, sum over pins
        tokens = torch.cat([comp_enc, pin_pooled,
                            _one_hot(obs["placement_mask"], 4)], dim=-1)
        if t in _COMP_ATTN:
            tokens = self.comp_attn(tokens)
        return tokens

    def _encode_spatial(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """RectanglePinSpatialModel (rectangle_pin_spatial_model.py:95-230)."""
        b = obs["grid"].shape[0]
        ge = self._encode_grid(obs["grid"])
        pe = self.pin_grid_conv(obs["pin_grid"]).reshape(b, -1)
        cgrid = obs["component_grid"]                 # [B, C, h, w, ch]
        ce = self.component_grid_conv(cgrid.reshape((-1,) + cgrid.shape[2:]))
        ce = ce.reshape(b, cgrid.shape[1], -1)        # NHWC rows, flattened
        tokens = torch.cat([ce, _one_hot(obs["placement_mask"], 4)], dim=-1)
        tokens = self.spatial_comp_attn(tokens)
        return torch.cat([ge, pe, tokens.reshape(b, -1)], dim=-1)

    def encode(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The full encoding vector of the configured preset."""
        t = self.cfg.model_type
        if t == "square":
            return self._encode_grid(obs["grid"])
        if t in ("rectangle", "rectangle_factorized"):
            return torch.cat([self._encode_grid(obs["grid"]),
                              self._encode_rect_features(obs)], dim=-1)
        if t == "rectangle_spatial_pin":
            return self._encode_spatial(obs)
        tokens = self._encode_pin_components(obs)
        flat = tokens.reshape(tokens.shape[0], -1)
        if t == "rectangle_pin_attn_all_no_grid":
            # no grid encoding (rectangle_pin_attn_all_model_no_grid.py:63-64)
            return flat
        return torch.cat([self._encode_grid(obs["grid"]), flat], dim=-1)

    # -- heads -------------------------------------------------------------

    def forward(self, obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The JAX ``__call__``: {"logits", "value"} for joint presets,
        {"encoding", "value"} for factorized ones. Train or eval mode (the
        BatchNorm statistics) follows ``self.training``."""
        enc = self.encode(obs)
        value = self.value_head(enc)[..., 0]
        if self.cfg.is_factorized:
            return {"encoding": enc, "value": value}
        logits = self.logits_head(enc)
        flat_mask = obs["action_mask"].reshape(logits.shape[0], -1)
        return {"logits": mask_logits(logits, flat_mask), "value": value}

    # factorized heads (rectangle_model_factorized.py:133-311)
    def o_logits(self, enc: torch.Tensor,
                 x_norm: Optional[torch.Tensor] = None,
                 y_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.cfg.factorization == "orientation":
            return self.orientation_head(enc)
        return self.orientation_head(
            torch.cat([enc, x_norm[..., None], y_norm[..., None]], -1))

    def x_logits(self, enc: torch.Tensor,
                 onehot_o: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.cfg.factorization == "orientation":
            return self.x_head(torch.cat([enc, onehot_o], -1))
        return self.x_head(enc)

    def y_logits(self, enc: torch.Tensor,
                 onehot_o: Optional[torch.Tensor] = None,
                 x_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.cfg.factorization == "orientation":
            return self.y_head(torch.cat([enc, onehot_o, x_norm[..., None]],
                                         -1))
        return self.y_head(torch.cat([enc, x_norm[..., None]], -1))


def build_model(cfg: ModelConfig,
                component_hw: Optional[Tuple[int, int]] = None
                ) -> PlacementModel:
    if cfg.model_type not in MODEL_REGISTRY:
        raise KeyError(f"unknown model type {cfg.model_type!r}")
    return PlacementModel(cfg, component_hw)


def init_parameters(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Flax's default initialization, drawn from ``gen`` on the CPU: every
    Dense and Conv kernel ``lecun_normal`` (a normal truncated to 2
    standard deviations, std sqrt(1 / fan_in) / 0.8796), biases zero,
    BatchNorm scale 1, bias 0, statistics (0, 1). The numbers are not
    JAX's (other generators); their distribution is."""
    stddev = 1.0 / 0.87962566103423978
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                w = torch.empty(m.weight.shape, dtype=F32)
                nn.init.trunc_normal_(w, std=stddev / math.sqrt(fan_in),
                                      a=-2 * stddev / math.sqrt(fan_in),
                                      b=2 * stddev / math.sqrt(fan_in),
                                      generator=gen)
                m.weight.copy_(w)
                m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.reset_parameters()
    return model
