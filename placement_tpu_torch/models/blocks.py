"""Model building blocks (port of ``placement_tpu/models/blocks.py``;
reference: agent/models/model_building_blocks.py).

``ConvBlocks`` = N x (Conv2D + BatchNorm + activation (+ max-pool));
``SelfAttention`` is single-head QKV attention with a relu output and no
scaling. Each block takes and returns the JAX layout (NHWC) and runs NCHW
inside, so a caller that flattens its output flattens in the JAX order and
the Dense weights carried from Flax keep their rows. Submodules carry the
Flax auto-names (``Conv_0``, ``BatchNorm_0``, ``Dense_0``, ...), so a
Flax parameter path maps one to one onto a ``state_dict`` key
(``models/convert.py``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn
from torch.nn import functional as F

ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}

#: f32's lowest finite value: a masked logit
NEG = torch.finfo(torch.float32).min


def get_activation(name) -> Callable:
    """String -> fn map (utils/agent/utils.py:106-151)."""
    if callable(name):
        return name
    return ACTIVATIONS[name]


def batch_norm(cls, features: int) -> nn.Module:
    """Flax ``BatchNorm(momentum=0.99, epsilon=1e-3)``: PyTorch counts the
    momentum from the other side."""
    return cls(features, eps=1e-3, momentum=0.01)


def _same_pad(k: int) -> Tuple[int, int, int, int]:
    """XLA's "SAME" split for stride 1: low = total // 2, the rest high
    (F.pad order: W low, W high, H low, H high)."""
    lo = (k - 1) // 2
    hi = k - 1 - lo
    return (lo, hi, lo, hi)


class ConvBlocks(nn.Module):
    """N stacked Conv+Norm+act(+pool) blocks on NHWC input; a 3-D input
    [B, H, W] gets one channel (model_building_blocks.py:59-60)."""

    def __init__(self, in_channels: int, num_blocks: int, num_filters: int,
                 kernel_size: int, activation: str = "relu",
                 max_pool: bool = False, max_pool_kernel_size: int = 4,
                 padding: str = "VALID", use_batch_norm: bool = True):
        super().__init__()
        if padding not in ("VALID", "SAME"):
            raise ValueError(f"padding must be VALID or SAME, got {padding!r}")
        self.num_blocks = num_blocks
        self.kernel_size = kernel_size
        self.act = get_activation(activation)
        self.max_pool = max_pool
        self.pool = max_pool_kernel_size
        self.padding = padding
        self.use_batch_norm = use_batch_norm
        c = in_channels
        for i in range(num_blocks):
            setattr(self, f"Conv_{i}", nn.Conv2d(c, num_filters, kernel_size))
            if use_batch_norm:
                setattr(self, f"BatchNorm_{i}",
                        batch_norm(nn.BatchNorm2d, num_filters))
            c = num_filters
        self.out_channels = c

    def out_hw(self, h: int, w: int) -> Tuple[int, int]:
        """Spatial size of the output for an h x w input."""
        for _ in range(self.num_blocks):
            if self.padding == "VALID":
                h, w = h - self.kernel_size + 1, w - self.kernel_size + 1
            if self.max_pool:
                h, w = h // self.pool, w // self.pool
        return h, w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:                       # [B, H, W] -> [B, H, W, 1]
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)              # NHWC -> NCHW
        for i in range(self.num_blocks):
            if self.padding == "SAME":
                x = F.pad(x, _same_pad(self.kernel_size))
            x = getattr(self, f"Conv_{i}")(x)
            if self.use_batch_norm:
                x = getattr(self, f"BatchNorm_{i}")(x)
            x = self.act(x)
            if self.max_pool:
                x = F.max_pool2d(x, self.pool, self.pool)
        return x.permute(0, 2, 3, 1)           # back to NHWC


class SelfAttention(nn.Module):
    """Single-head QKV self-attention, relu output, no scaling by
    sqrt(d) (model_building_blocks.py:160-179, JAX ``blocks.py:63-80``)."""

    def __init__(self, in_features: int, hidden_size: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, hidden_size)    # q
        self.Dense_1 = nn.Linear(in_features, hidden_size)    # k
        self.Dense_2 = nn.Linear(in_features, hidden_size)    # v

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.Dense_0(x), self.Dense_1(x), self.Dense_2(x)
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return torch.relu(w @ v)


def mask_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """logits + max(log(max(mask, 0)), f32.min) (square_model.py:137-139)."""
    return logits + torch.log(mask.clamp_min(0.0)).clamp_min(NEG)
