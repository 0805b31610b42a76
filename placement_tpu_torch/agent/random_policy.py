"""Random-policy baselines (port of ``placement_tpu/agent/random_policy.py``;
reference: agent/random/random_policy_*.py).

The reference picks uniformly from ``np.argwhere(env.action_mask == 1)``
per step in a Python loop (:25-59); here the whole batch draws masked
uniform actions on the device and steps through ``core.make_batched``,
with nothing read back until the episode returns are counted at the end.
"""

from __future__ import annotations

from typing import Optional

import torch

from placement_tpu_torch.env import core
from placement_tpu_torch.env.types import EnvParams
from placement_tpu_torch.env.wrappers import decode_flat_action


def random_action(gen: torch.Generator, params: EnvParams,
                  action_mask: torch.Tensor) -> torch.Tensor:
    """Uniform over each board's legal actions, by Gumbel-max over the
    flattened mask [B, O, H, W] (square: O = 1, or [B, H, W]) -> i32[B, 3].
    A board with no legal action draws action 0."""
    b = action_mask.shape[0]
    flat = action_mask.reshape(b, -1)
    u = torch.rand(flat.shape, generator=gen, device=flat.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    idx = torch.argmax(torch.where(flat > 0, gumbel, -float("inf")), dim=1)
    return decode_flat_action(params, idx)


def simulate(params: EnvParams, gen: torch.Generator, num_episodes: int,
             batch: Optional[int] = None,
             device: core.Device = "cuda") -> torch.Tensor:
    """Play ``num_episodes`` random-policy episodes on ``batch`` boards on
    ``device`` (``gen`` a ``torch.Generator`` there); returns the episode
    returns f32[num_episodes] in the order they ended
    (random_policy_square.py:25-59 semantics, batched). Runs ``area + 2``
    steps; raises if fewer episodes ended, and without a card unless
    ``device`` is the CPU."""
    batch = batch or min(num_episodes, 256)
    reset_b, step_b, _ = core.make_batched(params, device)
    states = reset_b(gen, batch)
    max_steps = params.area + 2       # episodes end well before this

    rewards, dones = [], []
    for _ in range(max_steps):
        states, reward, done, _ = step_b(
            states, random_action(gen, params, states.action_mask), gen)
        rewards.append(reward)
        dones.append(done)

    # per-board episode returns, emitted at done boundaries (time-major)
    acc = torch.zeros_like(rewards[0])
    nan = torch.full_like(acc, float("nan"))
    emitted = []
    for r, d in zip(rewards, dones):
        total = acc + r
        emitted.append(torch.where(d, total, nan))
        acc = torch.where(d, 0.0, total)
    flat = torch.stack(emitted).reshape(-1)
    flat = flat[~torch.isnan(flat)]       # the one read back to the host
    if flat.shape[0] < num_episodes:
        # long-episode configs can end fewer episodes in the window;
        # returning fewer would bias any mean computed from the result
        raise ValueError(
            f"simulate completed only {flat.shape[0]} episodes (< requested "
            f"{num_episodes}) within {max_steps} steps at batch={batch}; "
            "raise `batch` or lower `num_episodes`")
    return flat[:num_episodes]
