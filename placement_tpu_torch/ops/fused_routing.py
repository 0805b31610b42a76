"""Centroid routing reward on ``[B, P]`` pin tables (port of
``placement_tpu/ops/fused_routing.py``).

These are the plain PyTorch bodies of the fused rollout's terminal reward.
``ops/fused_rollout.py::rollout_chunk_reference`` calls them; the CUDA
kernel (``ops/csrc/fused_rollout.cu``) carries its own device-side copy of
the same arithmetic, and ``chip_smoke.py`` holds the two together.

  * ``centroid_wl_int`` — centroid star routing
    (route_pins_centroid, dummy_env_rectangular_pin.py:1296-1324)
  * ``reward_rows``     — reward composition (find_reward:832-975), centroid
    only; beam and "both" are queue 2 items of ROADMAP.md

The arithmetic mirrors the JAX module operation for operation: coordinates
are small integers, so sums and squared distances are exact, ``sqrt`` is
correctly rounded and the crossing predicate is exact. Only the order in
which ``wl`` sums its lanes differs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from placement_tpu_torch.env.types import EnvParams

F32 = torch.float32
I32 = torch.int32

#: reward types whose routing is still to be ported (ROADMAP.md queue 2)
UNPORTED_REWARDS = {
    "beam": "ROADMAP.md queue 2 item 2 (beam-search routing reward)",
    "both": "ROADMAP.md queue 2 item 3 ('both' routing reward)",
}


def _f32(v: float) -> torch.Tensor:
    """A host double rounded to f32 (the JAX module's ``F32(float(v))``)."""
    return torch.tensor(float(v), dtype=F32)


def centroid_wl_int(params: EnvParams, pax: torch.Tensor, pay: torch.Tensor,
                    pnet: torch.Tensor, npin: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centroid-route wirelength and crossing count, ``([B,1] f32) * 2``.

    A net with exactly two pins routes pin0 -> pin1 directly, otherwise every
    pin connects to the net centroid; the crossing predicate runs on
    integer-scaled coordinates (pin * count, centroid as the raw coordinate
    sum) so it is exact arithmetic. Pins of net ``n`` are taken to sit at
    table positions ``start_n + rank`` (the generator's net-grouped order),
    exactly as the JAX body assumes.
    """
    B, P = pax.shape
    N = params.max_num_nets
    dev = pax.device
    iota = torch.arange(P, dtype=I32, device=dev).expand(B, P)

    x = pax.to(F32)
    y = pay.to(F32)
    zero = torch.zeros((), dtype=F32, device=dev)
    in_use = iota < npin
    cnt_n, cx_n, cy_n, sx_n, sy_n, start_n = [], [], [], [], [], []
    run = torch.zeros((B, 1), dtype=I32, device=dev)
    for n in range(N):
        mn = (pnet == n) & in_use
        c = mn.sum(dim=1, keepdim=True, dtype=I32)
        denom = torch.clamp(c, min=1).to(F32)
        sx = torch.where(mn, x, zero).sum(dim=1, keepdim=True)
        sy = torch.where(mn, y, zero).sum(dim=1, keepdim=True)
        cnt_n.append(c)
        sx_n.append(sx)
        sy_n.append(sy)
        cx_n.append(sx / denom)
        cy_n.append(sy / denom)
        start_n.append(run)
        run = run + c
    # per-pin segment pin -> centroid; 2-pin nets route pin0 -> pin1 in
    # slot 0 only. Real endpoints (x2, y2) feed wirelength; integer-scaled
    # ones (x2s/y2s = coordinate sums, x1s/y1s = pin * count, scale s) feed
    # the exact crossing predicate.
    x2 = torch.zeros((B, P), dtype=F32, device=dev)
    y2 = torch.zeros_like(x2)
    x2s = torch.zeros_like(x2)
    y2s = torch.zeros_like(x2)
    s = torch.ones_like(x2)
    svalid = torch.zeros((B, P), dtype=torch.bool, device=dev)
    for n in range(N):
        mn = (pnet == n) & in_use
        rin = iota - start_n[n]
        two = cnt_n[n] == 2
        first = mn & (rin == 0)
        second = mn & (rin == 1)
        xs = torch.where(second, x, zero).sum(dim=1, keepdim=True)
        ys = torch.where(second, y, zero).sum(dim=1, keepdim=True)
        ex = torch.where(two, xs, cx_n[n])
        ey = torch.where(two, ys, cy_n[n])
        exs = torch.where(two, xs, sx_n[n])
        eys = torch.where(two, ys, sy_n[n])
        sc = torch.where(two, torch.ones((), dtype=F32, device=dev),
                         torch.clamp(cnt_n[n], min=1).to(F32))
        x2 = torch.where(mn, ex, x2)
        y2 = torch.where(mn, ey, y2)
        x2s = torch.where(mn, exs, x2s)
        y2s = torch.where(mn, eys, y2s)
        s = torch.where(mn, sc, s)
        svalid = svalid | (mn & ~(two & ~first))
    dx = x - x2
    dy = y - y2
    wl = torch.where(svalid, torch.sqrt(dx * dx + dy * dy),
                     zero).sum(dim=1, keepdim=True)
    x1s = x * s
    y1s = y * s

    # all-pairs cross-net crossings (find_num_intersection:663;
    # is_intersect:687): shared endpoint counts, parallel never counts,
    # otherwise orientation sign tests; pair (p, q) brought to the common
    # integer frame s_p * s_q.
    ints = torch.zeros((B, 1), dtype=F32, device=dev)
    for p in range(P):
        sp = s[:, p:p + 1]
        hit = _seg_intersect(
            x1s[:, p:p + 1] * s, y1s[:, p:p + 1] * s,
            x2s[:, p:p + 1] * s, y2s[:, p:p + 1] * s,
            x1s * sp, y1s * sp, x2s * sp, y2s * sp)
        ok = (svalid & (iota > p) & (pnet != pnet[:, p:p + 1])
              & svalid[:, p:p + 1])
        ints = ints + (hit & ok).to(F32).sum(dim=1, keepdim=True)
    return wl, ints


def _seg_intersect(ax1, ay1, ax2, ay2, bx1, by1, bx2, by2) -> torch.Tensor:
    """is_intersect (dummy_env_rectangular_pin.py:687-739) as orientation
    sign tests on (integer-valued) f32 coordinates — exact arithmetic."""
    same = (((ax1 == bx1) & (ay1 == by1))
            | ((ax1 == bx2) & (ay1 == by2))
            | ((ax2 == bx1) & (ay2 == by1))
            | ((ax2 == bx2) & (ay2 == by2)))
    det = (ax1 - ax2) * (by1 - by2) - (ay1 - ay2) * (bx1 - bx2)
    o1 = (ax2 - ax1) * (by1 - ay1) - (ay2 - ay1) * (bx1 - ax1)
    o2 = (ax2 - ax1) * (by2 - ay1) - (ay2 - ay1) * (bx2 - ax1)
    o3 = (bx2 - bx1) * (ay1 - by1) - (by2 - by1) * (ax1 - bx1)
    o4 = (bx2 - bx1) * (ay2 - by1) - (by2 - by1) * (ax2 - bx1)
    opp_b = ((o1 >= 0) & (o2 <= 0)) | ((o1 <= 0) & (o2 >= 0))
    opp_a = ((o3 >= 0) & (o4 <= 0)) | ((o3 <= 0) & (o4 >= 0))
    return same | ((det != 0) & opp_b & opp_a)


def reward_rows(params: EnvParams, pax: torch.Tensor, pay: torch.Tensor,
                pnet: torch.Tensor, npin: torch.Tensor) -> torch.Tensor:
    """Routed terminal reward ``f32[B, 1]`` (centroid routing).

    The worst-case penalty branch lives in the rollout (reward_rows is only
    evaluated on placed-all episode ends).
    """
    if params.reward_type in UNPORTED_REWARDS:
        raise NotImplementedError(
            f"reward_type={params.reward_type!r} is not ported yet: "
            f"{UNPORTED_REWARDS[params.reward_type]}")
    wl, ints = centroid_wl_int(params, pax, pay, pnet, npin)
    dev = wl.device
    lam_w = _f32(params.weight_wirelength).to(dev)
    wl_norm = _f32(params.wirelength_normalizer).to(dev)
    lam_i = _f32(params.weight_num_intersections).to(dev)
    int_norm = _f32(params.intersections_normalizer).to(dev)
    return -(lam_w * (wl / wl_norm) + lam_i * (ints / int_norm))
