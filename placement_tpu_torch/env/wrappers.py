"""Flat action-space codecs (port of ``placement_tpu/env/wrappers.py``): the
reference's wrapper layer (utils/environment/env_wrappers.py) as index
math.

``FlatteningActionWrapperRect.action`` (:80-98) decodes a flat id by
``divmod(a, h*w)`` then ``divmod(rem, w)``; the square wrapper (:184-199)
uses ``divmod(a, w)``.
"""

from __future__ import annotations

import torch

from placement_tpu_torch.env.types import EnvParams, Variant


def flat_action_size(params: EnvParams) -> int:
    if params.variant == Variant.SQUARE:
        return params.height * params.width
    return params.num_orientations * params.height * params.width


def decode_flat_action(params: EnvParams, flat: torch.Tensor) -> torch.Tensor:
    """flat int[...] -> (orientation, x, y) i32[..., 3]."""
    h, w = params.height, params.width
    if params.variant == Variant.SQUARE:
        o, rem = torch.zeros_like(flat), flat
    else:
        o, rem = flat // (h * w), flat % (h * w)
    return torch.stack([o, rem // w, rem % w], dim=-1).to(torch.int32)


def encode_flat_action(params: EnvParams, action: torch.Tensor) -> torch.Tensor:
    """(o, x, y) int[..., 3] -> flat id (the inverse of decode)."""
    h, w = params.height, params.width
    o, x, y = action[..., 0], action[..., 1], action[..., 2]
    if params.variant == Variant.SQUARE:
        return x * w + y
    return o * h * w + x * w + y


def flatten_mask(params: EnvParams, mask: torch.Tensor) -> torch.Tensor:
    """action_mask [..., O, H, W] (or [..., H, W] square) -> [..., A]."""
    lead = mask.dim() - (2 if params.variant == Variant.SQUARE else 3)
    return mask.reshape(mask.shape[:lead] + (flat_action_size(params),))
