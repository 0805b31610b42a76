"""Pooled auto-reset: instance generation amortized over a rollout chunk (port
of ``placement_tpu/env/pooled.py``).

``core.step_autoreset`` draws a fresh instance for every board on every
step and keeps it only where the board finished: the reset is 417 of the
flagship auto-reset step's 776 PyTorch operations. Here one batched
generator call
per chunk draws a pool of ``[K, B]`` fresh boards, and each board takes its
next pool entry when an episode ends. The semantics equal
``core.step_autoreset``'s as long as no board resets more than K times a
chunk; past that the index wraps and replays an instance of the same pool,
which ``rollout_chunk`` counts (``wrap_count``).

``route_budget`` gates the terminal routing reward to the boards that
finished this step (``gated_terminal_rewards``). JAX branches on the device
(two ``lax.cond`` on the finisher count); eager PyTorch has no device-side
branch, so the count is read to the host once per step (a 4-byte copy and
a sync), and only when ``route_budget`` is set: without it a step never
waits for the card.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from placement_tpu_torch.env import core, routing
from placement_tpu_torch.env.types import (
    STATE_FIELDS, EnvParams, EnvState, Variant)

I32 = torch.int32
F32 = torch.float32


def default_pool_size(params: EnvParams, chunk_len: int) -> int:
    """Pool entries per board so that no board exhausts its pool within a
    chunk under normal episode lengths: the chunk over a lower bound on the
    episode length, plus 2 (JAX ``agent/ppo.py::default_pool_size``, the
    formula copied; a heuristic, checked at run time by ``wrap_count``)."""
    if params.variant == Variant.SQUARE:
        # worst-case packing over the valid-origin grid: one placement
        # blocks a (2n-1)^2 patch of origins
        n = params.component_n
        origins = (params.height - n + 1) * (params.width - n + 1)
        est = max(origins // ((2 * n - 1) ** 2), 1)
    else:
        fill = params.area // max(
            params.max_component_h * params.max_component_w, 1)
        est = max(min(params.min_num_components, fill), 1)
    return max(min(chunk_len, chunk_len // est + 2), 2)


def make_pool(params: EnvParams, gen: torch.Generator, pool_size: int,
              batch: int, slice_size: int = 4) -> EnvState:
    """``pool_size`` fresh instances per board, on ``gen``'s device, drawn
    by ``ceil(pool_size / slice_size)`` calls of the batched reset of
    ``slice_size * batch`` boards each. Returns an ``EnvState`` whose fields
    lead with ``[pool_size, batch]``: entry ``[i, b]`` is board ``b``'s
    (i+1)-th replacement episode."""
    slice_size = min(slice_size, pool_size)
    n_slices = -(-pool_size // slice_size)
    slices = [core.reset(params, gen, slice_size * batch, gen.device)
              for _ in range(n_slices)]
    return EnvState(**{
        f: torch.cat([getattr(s, f) for s in slices]).reshape(
            (n_slices * slice_size, batch)
            + getattr(slices[0], f).shape[1:])[:pool_size]
        for f in STATE_FIELDS})


def take(pool: EnvState, counts: torch.Tensor) -> EnvState:
    """Each board's next pool entry: ``pool[counts[b] % K, b]``."""
    k, b = pool.done.shape
    idx = (counts % k).long()
    rows = torch.arange(b, device=counts.device)
    return EnvState(**{f: getattr(pool, f)[idx, rows] for f in STATE_FIELDS})


def gated_terminal_rewards(params: EnvParams, stepped: EnvState,
                           done: torch.Tensor, placed_all_eff: torch.Tensor,
                           budget: int) -> Tuple[torch.Tensor, ...]:
    """Terminal routing rewards of the done boards only, as ``(reward,
    info_wl, info_int)`` f32[B], zero on the other boards.

    ``core.step`` routes every board on every step and keeps the result only
    where the board finished. Here the finishers are counted on the host
    (one sync) and, as JAX's two ``lax.cond`` levels do:

      * no board finished          -> no routing at all (4 steps of 5 on
                                      the flagship)
      * <= budget boards finished  -> the finishers are moved to the front
                                      by a stable sort of ``~done`` and
                                      ``budget`` boards are routed
      * more than budget           -> the whole batch is routed

    Per board the routing is the same function either way: the crossing
    count is exact, the wirelength equal to the eager path's within one
    f32 ulp (JAX ``pooled.py:86-93``).
    """
    b = done.shape[0]
    zero = torch.zeros((b,), dtype=F32, device=done.device)
    n_done = int(done.sum())                  # the one sync of the step
    if n_done == 0:
        return zero, zero.clone(), zero.clone()
    if n_done <= budget:
        idx = torch.argsort((~done).to(torch.uint8), stable=True)[:budget]
        r, wl, ni = routing.terminal_reward(
            params, stepped.pin_abs_x[idx], stepped.pin_abs_y[idx],
            stepped.pin_net[idx], placed_all_eff[idx])
        # rows past the finishers land on live boards, masked below
        r, wl, ni = (zero.index_copy(0, idx, v) for v in (r, wl, ni))
    else:
        r, wl, ni = routing.terminal_reward(
            params, stepped.pin_abs_x, stepped.pin_abs_y, stepped.pin_net,
            placed_all_eff)
    return (torch.where(done, r, 0.0), torch.where(done, wl, 0.0),
            torch.where(done, ni, 0.0))


def step_autoreset_pooled(
    params: EnvParams, states: EnvState, actions: torch.Tensor,
    pool: EnvState, counts: torch.Tensor, route_budget: Optional[int] = None,
) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor, Dict]:
    """Step every board; a done board is replaced by its next pool entry
    (the returned state is the first of the new episode, as
    ``core.step_autoreset``'s). ``counts`` (i32[B]) counts the pool entries
    each board has taken. Returns (states', counts', reward, done, info).

    ``route_budget`` (pin variants; others ignore it): route only the
    boards that finished this step (``gated_terminal_rewards``), at the
    cost of one host sync a step."""
    if route_budget is not None and params.has_pins:
        stepped, _, done, aux = core.step(params, states, actions,
                                          defer_routing=True)
        reward, wl, ni = gated_terminal_rewards(
            params, stepped, done, aux["placed_all_eff"], route_budget)
        stepped = stepped.replace(info_wirelength=wl, info_intersections=ni)
        info = {"wirelength": wl, "num_intersections": ni}
    else:
        stepped, reward, done, info = core.step(params, states, actions)
    new_states = EnvState.where(done, take(pool, counts), stepped)
    return new_states, counts + done.to(I32), reward, done, info


PolicyFn = Callable[[torch.Generator, EnvParams, EnvState], torch.Tensor]


def rollout_chunk(params: EnvParams, policy_fn: PolicyFn, chunk_len: int,
                  pool_size: int, slice_size: int = 4,
                  route_budget: Optional[int] = None,
                  device: core.Device = "cuda") -> Callable:
    """A pooled rollout chunk on ``device`` (the card unless the CPU is
    asked for; raises without a card).

    ``policy_fn(gen, params, states) -> actions`` i32[B, 3]: the port hands
    the policy the boards' state (JAX hands it the action mask), so that a
    network policy can observe them (``Policy.policy_fn``); the random
    policy is ``lambda g, p, s: random_action(g, p, s.action_mask)``.
    Returns ``fn(states, gen) -> (states, reward_sum, done_count,
    wrap_count)``, the last three 0-d tensors on the device. The pool is
    drawn inside the call, so a timed chunk includes generation.

    ``wrap_count`` counts the boards that took more than ``pool_size``
    entries this chunk, whose index wrapped and replayed an instance of the
    same pool: a caller with variable-length episodes must check it."""
    device = core.check_device(device, "rollout_chunk")

    def fn(states: EnvState, gen: torch.Generator):
        if states.device.type != device.type:
            raise ValueError(f"states on {states.device}, chunk on {device}")
        batch = states.batch
        pool = make_pool(params, gen, pool_size, batch, slice_size)
        counts = torch.zeros((batch,), dtype=I32, device=states.device)
        reward_sum = torch.zeros((), dtype=F32, device=states.device)
        done_count = torch.zeros((), dtype=torch.int64, device=states.device)
        for _ in range(chunk_len):
            actions = policy_fn(gen, params, states)
            states, counts, reward, done, _ = step_autoreset_pooled(
                params, states, actions, pool, counts, route_budget)
            reward_sum = reward_sum + reward.sum()
            done_count = done_count + done.sum()
        wrapped = (counts > pool_size).sum()
        return states, reward_sum, done_count, wrapped

    return fn
