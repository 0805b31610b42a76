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
import torch.distributed.nn.functional as dist_nn
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


class BatchNorm(nn.Module):
    """Flax ``BatchNorm(momentum=0.99, epsilon=1e-3)`` over dimension 1 of
    [B, C] or [B, C, H, W] (JAX ``blocks.py:54-55``, ``zoo.py:101-103``),
    with the ``nn.BatchNorm*`` parameter and buffer names, so a state dict
    carries across unchanged (``models/convert.py``).

    Eval mode normalises with the running statistics by ``F.batch_norm``,
    as ``nn.BatchNorm2d`` does. Train mode follows Flax, not PyTorch: it
    normalises with the biased batch statistics, mean E[x] and variance
    max(E[x^2] - E[x]^2, 0) (Flax's ``use_fast_variance``), with gradients
    through both, and moves the running statistics by
    ``r <- 0.99 r + 0.01 batch`` with that same biased variance.
    ``nn.BatchNorm*`` would move the running variance by the unbiased one,
    n / (n - 1) larger. ``num_batches_tracked`` stays 0: it exists only so
    that the state dict keeps PyTorch's keys.

    With a process group (``sync_batch_norm``), train mode takes the
    statistics of the global batch, as JAX's GSPMD computes them over a
    sharded batch: the ranks' sums, sums of squares and counts in one
    stacked, autograd-aware ``all_reduce``, then the same rule.
    ``nn.SyncBatchNorm`` would move the running variance by the unbiased
    variance too."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-3):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.int64))
        self.group = None

    def reset_parameters(self) -> None:
        """Flax's initial values: scale 1, bias 0, statistics (0, 1)."""
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = [d for d in range(x.dim()) if d != 1]
        if self.group is None:
            mean = x.mean(dim=dims)
            var = torch.clamp_min((x * x).mean(dim=dims) - mean * mean, 0.0)
        else:
            count = torch.full_like(self.running_mean,
                                    x.numel() // x.shape[1])
            total = dist_nn.all_reduce(
                torch.stack([x.sum(dim=dims), (x * x).sum(dim=dims), count]),
                group=self.group)
            mean = total[0] / total[2]
            var = torch.clamp_min(total[1] / total[2] - mean * mean, 0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_((1 - m) * mean)
            self.running_var.mul_(m).add_((1 - m) * var)
        shape = [1] * x.dim()
        shape[1] = x.shape[1]
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + \
            self.bias.view(shape)


def sync_batch_norm(module: nn.Module, group) -> nn.Module:
    """Every ``BatchNorm`` of ``module`` takes the global batch's
    statistics over ``group`` in train mode (None: its own batch's)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return module


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
                setattr(self, f"BatchNorm_{i}", BatchNorm(num_filters))
            c = num_filters
        self.out_channels = c

    def _conv_hw(self, h: int, w: int) -> Tuple[int, int]:
        """Spatial size after one conv: a VALID conv on a map smaller than
        its kernel gives an empty side (0), as Flax's does."""
        if self.padding == "SAME":
            return h, w
        k = self.kernel_size
        return max(h - k + 1, 0), max(w - k + 1, 0)

    def out_hw(self, h: int, w: int) -> Tuple[int, int]:
        """Spatial size of the output for an h x w input (Flax's shape
        rule: a side that a conv or pool empties stays 0)."""
        for _ in range(self.num_blocks):
            h, w = self._conv_hw(h, w)
            if self.max_pool:
                h, w = h // self.pool, w // self.pool
        return h, w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:                       # [B, H, W] -> [B, H, W, 1]
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)              # NHWC -> NCHW
        h, w = x.shape[2], x.shape[3]
        for i in range(self.num_blocks):
            conv = getattr(self, f"Conv_{i}")
            h, w = self._conv_hw(h, w)
            if h * w == 0:
                x = _empty_map(x, conv.out_channels, h, w,
                               conv.weight, conv.bias)
            else:
                if self.padding == "SAME":
                    x = F.pad(x, _same_pad(self.kernel_size))
                x = conv(x)
            if self.use_batch_norm:
                x = getattr(self, f"BatchNorm_{i}")(x)
            x = self.act(x)
            if self.max_pool:
                h, w = h // self.pool, w // self.pool
                x = (_empty_map(x, x.shape[1], h, w) if h * w == 0
                     else F.max_pool2d(x, self.pool, self.pool))
        return x.permute(0, 2, 3, 1)           # back to NHWC


def _empty_map(x: torch.Tensor, channels: int, h: int, w: int,
               *params: torch.Tensor) -> torch.Tensor:
    """The empty [B, channels, h, w] map (h * w == 0) that Flax's VALID
    conv or pool returns on a map smaller than its window; PyTorch's
    refuse one. A train-mode batch norm of it gives NaN statistics, as
    Flax's does. It is a function of ``x`` and ``params`` whose value
    cannot depend on them, so their gradients are 0, as Flax's are, and
    not None."""
    tie = x.sum() + sum(p.sum() for p in params)
    return tie.expand(x.shape[0], channels, h, w)


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
