"""The fused rollout chunk (port of ``placement_tpu/ops/fused_rollout.py``).

One call runs ``num_steps`` steps of a placement environment on every board
under a random legal policy with auto-reset: action sampling, placement (and
pin rotation), the next legality planes, the reward and, on episode end, the
regeneration of a fresh instance. Two implementations of the same function
live here:

  * ``rollout_chunk_reference`` — plain PyTorch on ``[B, F]`` rows, on any
    device. The CPU tests hold it to the JAX kernel (run under the Pallas
    interpreter) and ``chip_smoke.py`` holds the CUDA kernel to it.
  * ``ops/csrc/fused_rollout_warp.cu`` (the pin environments) and
    ``fused_rollout.cu`` (the reduced ones, and the C entry points) — the
    hand-written CUDA kernels, one warp per board (the general square four
    boards a warp) on the row helpers of ``fused_warp.cuh``, launched by
    ``FusedRollout`` on CUDA tensors.

``make_fused_rollout`` returns a ``FusedRollout``: on CPU tensors it runs the
plain version, on CUDA tensors it launches the kernel (or raises) and counts
the launch in ``FusedRollout.launches``.

The random stream is the JAX kernel's counter hash (``_Rng``), bit for bit:
the same ``(params, leaves, seed, num_steps, block)`` give the same leaves
in all three implementations. ``block`` is the LOGICAL block of the salt,
whatever the launch geometry.

Covered: every specialisation of the JAX kernel. PIN / PIN_SPATIAL with the
``centroid``, ``beam`` or ``both`` reward (one kernel each, ``kernel_name``),
with fixed pins per net or with ``max_num_pins_per_net >
min_num_pins_per_net`` (the softmax-normal net allocation, a branch of the
generator); the SQUARE and RECT reduced kernels (+1 per placement, no pin
tables). Each kernel has a default instantiation (the flagship's sizes)
and a general one (``needs_general``: more than 8 nets or 16 pins per net,
or a side over 32), which together take the JAX kernel's whole envelope
and boards of up to 32 x 32 (``KERNEL_CAPACITY``).
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from placement_tpu_torch.env.types import EnvParams, Variant
from placement_tpu_torch.ops import fused_routing
from placement_tpu_torch.ops.fused_routing import _f64_rounded
from placement_tpu_torch.utils import profiling

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64
_M32 = 0xFFFFFFFF

Device = Union[str, torch.device]

_LEAVES = ("grid", "comp_h", "comp_w", "cursor", "num_components",
           "pin_rel_x", "pin_rel_y", "pin_abs_x", "pin_abs_y",
           "pin_net", "pin_comp", "num_pins", "plane0", "plane1")
_FLOAT_LEAVES = ("grid", "plane0", "plane1")

#: Fixed capacities of the CUDA kernels (the ``MAX_*`` constants of
#: ``csrc/fused_common.cuh``; the wrapper checks the library reports the
#: same): the JAX kernel's envelope and boards of up to 32 x 32. A board
#: has both sides within ``height`` and ``width``, or its area within
#: ``area`` (one side may then pass 32); every other table is a per-board
#: array of this length. Pin configs are held to the pin capacities (and
#: ``beam_width`` for the beam and "both" rewards), SQUARE / RECT only to
#: the board and ``components_nopin``.
KERNEL_CAPACITY = {
    "height": 32,
    "width": 32,
    "area": 144,
    "components": 8,
    "nets": 24,
    "pins_per_net": 48,
    "pins": 48,
    "pins_per_component": 16,
    "components_nopin": 64,
    "beam_width": 4,
}
#: What the default instantiation of each kernel holds (``DEFAULT_*``):
#: a grid row per lane and the flagship-sized pin tables. A config past
#: these runs the general instantiation (``needs_general``).
DEFAULT_CAPACITY = {"height": 32, "width": 32, "nets": 8, "pins_per_net": 16}

#: The kernel's specialisations, in the order of the C enum ``Kernel``.
KERNELS = ("centroid", "beam", "both", "square", "rect")


def kernel_name(params: EnvParams) -> str:
    """The specialisation of the kernel that runs ``params``."""
    if params.variant == Variant.SQUARE:
        return "square"
    if params.variant == Variant.RECT:
        return "rect"
    return params.reward_type


def _combos(params: EnvParams) -> "list[tuple[int, int]]":
    """Footprints the kernel has legality planes for (``_build_kernel``
    :312-315): SQUARE's one ``component_n`` square, otherwise every
    (h, w) of the component ranges and its transpose."""
    if params.variant == Variant.SQUARE:
        return [(params.component_n, params.component_n)]
    combos = {(h, w)
              for h in range(params.min_component_h,
                             params.max_component_h + 1)
              for w in range(params.min_component_w,
                             params.max_component_w + 1)}
    return sorted(combos | {(w, h) for (h, w) in combos})


# ---------------------------------------------------------------------------
# Counter-hash PRNG (the JAX kernel's _mix / _Rng, in int64 arithmetic:
# PyTorch has no >> on uint32 tensors, so values are kept in [0, 2^32)
# inside int64 and every product is reduced mod 2^32 without overflow)
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) — split so no int64 overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 avalanche mix (u32 -> u32, carried in int64)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7feb352d)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846ca68b)
    x = x ^ (x >> 16)
    return x


class _Rng:
    """Counter-based stateless PRNG: two lowbias32 rounds over
    (salt, call index, element index), as the JAX kernel's ``_Rng``.

    ``salt`` is the unmixed per-board salt (int64 ``[B, 1]`` or scalar) and
    ``row`` the board's index within its logical block (int64 ``[B, 1]``).
    ``bits(width)`` draws a ``[B, width]`` array whose element ``(b, j)``
    equals the JAX ``bits((block, width))[row_b, j]`` under salt ``salt_b``.
    The call counter ``n`` advances once per draw, so each call site of the
    JAX kernel is the same call number here.
    """

    def __init__(self, salt: torch.Tensor, row: torch.Tensor):
        self.salt = _mix(salt & _M32)
        self.row = row
        self.n = 0

    def bits(self, width: int) -> torch.Tensor:
        self.n += 1
        call = (self.n * 2654435761) & _M32
        col = torch.arange(width, dtype=I64, device=self.row.device)
        idx = (self.row * width + col) & _M32
        return _mix(idx ^ _mix(call ^ self.salt))

    def uniform(self, width: int) -> torch.Tensor:
        """f32 uniforms in [0, 1) from the top 24 bits."""
        return (self.bits(width) >> 8).to(F32) * (1.0 / (1 << 24))

    def randint(self, lo, hi, width: int) -> torch.Tensor:
        """Uniform ints in [lo, hi] (host ints or [B,1] int32 tensors)."""
        u = self.uniform(width)
        span = hi - lo + 1
        span_f = float(span) if isinstance(span, int) else span.to(F32)
        draw = torch.floor(u * span_f).to(I32)
        return (lo + torch.minimum(draw, torch.as_tensor(
            span - 1, dtype=I32, device=draw.device))).to(I32)


def _lane_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, q] = table[b, idx[b, q]], 0 where idx is out of range (the
    value the JAX kernel's select-sum gather gives there)."""
    width = table.shape[1]
    ok = (idx >= 0) & (idx < width)
    got = torch.gather(table, 1, idx.clamp(0, width - 1).to(I64))
    return torch.where(ok, got, torch.zeros_like(got))


def _sort_desc_cols(keys: torch.Tensor, payloads: "list[torch.Tensor]"
                    ) -> Tuple[torch.Tensor, "list[torch.Tensor]"]:
    """Bubble sorting network over the columns of ``keys`` [B, n],
    descending, strict ``<`` (so stable); payloads ride along."""
    n = keys.shape[1]
    k = list(keys.unbind(1))
    pays = [list(p.unbind(1)) for p in payloads]
    for r in range(n):
        for i in range(n - 1 - r):
            swap = k[i] < k[i + 1]
            k[i], k[i + 1] = (torch.where(swap, k[i + 1], k[i]),
                              torch.where(swap, k[i], k[i + 1]))
            for p in pays:
                p[i], p[i + 1] = (torch.where(swap, p[i + 1], p[i]),
                                  torch.where(swap, p[i], p[i + 1]))
    return torch.stack(k, 1), [torch.stack(p, 1) for p in pays]


# ---------------------------------------------------------------------------
# Plain PyTorch version of the chunk (row layout: one row per board)
# ---------------------------------------------------------------------------

def _free_anchors(grid_hw: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """f32 [B, A]: 1 where a (ph, pw) footprint anchored at the cell is in
    bounds and covers no occupied cell."""
    B, H, W = grid_hw.shape
    padded = torch.nn.functional.pad(grid_hw, (0, pw, 0, ph))
    occ = torch.zeros_like(grid_hw)
    for dx in range(ph):
        for dy in range(pw):
            occ = occ + padded[:, dx:dx + H, dy:dy + W]
    xs = torch.arange(H, device=grid_hw.device).view(1, H, 1)
    ys = torch.arange(W, device=grid_hw.device).view(1, 1, W)
    inb = (xs + ph <= H) & (ys + pw <= W)
    return ((occ == 0.0) & inb).to(F32).reshape(B, H * W)


def _planes_for(params: EnvParams, grid: torch.Tensor, ch_c: torch.Tensor,
                cw_c: torch.Tensor, alive: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Legal planes (o=0 footprint (h, w); o=1 footprint (w, h)); a
    footprint outside ``_combos`` gives a zero plane."""
    B = grid.shape[0]
    grid_hw = grid.view(B, params.height, params.width)
    p0 = torch.zeros_like(grid)
    p1 = torch.zeros_like(grid)
    for (ph, pw) in _combos(params):
        free = _free_anchors(grid_hw, ph, pw)
        p0 = torch.where((ch_c == ph) & (cw_c == pw), free, p0)
        p1 = torch.where((cw_c == ph) & (ch_c == pw), free, p1)
    zero = torch.zeros((), dtype=F32, device=grid.device)
    return torch.where(alive, p0, zero), torch.where(alive, p1, zero)


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device).view(1, n)


def _allocate_net(params: EnvParams, rng: _Rng, space, m, k0):
    """One net's pin -> component allocation (allocate_pins_to_components_
    for_net:1171): sort components by free space, capped multinomial over
    the k largest, then an in-order water-fill of the residue. Returns the
    component of each of the net's M pin ranks and the space left."""
    C, M = params.max_components, params.max_num_pins_per_net
    dev = space.device
    iota_c = _iota(C, dev)
    key = space * (C + 1) + (C - 1 - iota_c)
    _, (s_space, s_idx) = _sort_desc_cols(
        key, [space, iota_c.expand_as(space)])
    not_enough = (torch.cumsum(s_space, 1) < m).sum(1, keepdim=True, dtype=I32)
    k = torch.maximum(k0, torch.clamp(not_enough + 1, max=C))
    w = torch.where(iota_c < k, s_space.to(F32),
                    torch.zeros((), dtype=F32, device=dev))
    tot_w = torch.maximum(w.sum(1, keepdim=True),
                          torch.tensor(1e-9, dtype=F32, device=dev))
    cw_cum = torch.cumsum(w, 1)
    ut = rng.uniform(M)
    binm = torch.zeros(ut.shape, dtype=I32, device=dev)
    for c in range(C - 1):
        binm = binm + (ut > cw_cum[:, c:c + 1] / tot_w).to(I32)
    act = _iota(M, dev) < m
    cnt = torch.stack([((binm == c) & act).sum(1, dtype=I32)
                       for c in range(C)], 1)
    cnt = torch.minimum(cnt, s_space)
    resid = m - cnt.sum(1, keepdim=True, dtype=I32)
    free = s_space - cnt
    before = torch.zeros_like(resid)
    cols = []
    for c in range(C):
        add = torch.minimum(torch.clamp(resid - before, min=0),
                            free[:, c:c + 1])
        cols.append(cnt[:, c:c + 1] + add)
        before = before + free[:, c:c + 1]
    cnt = torch.cat(cols, 1)
    bounds = torch.cumsum(cnt, 1, dtype=I32)
    ranks = _iota(M, dev)
    slot = torch.zeros((space.shape[0], M), dtype=I32, device=dev)
    for c in range(C):
        slot = slot + (ranks >= bounds[:, c:c + 1]).to(I32)
    comp_of = _lane_gather(s_idx, torch.clamp(slot, max=C - 1))
    new_space = torch.zeros_like(space).scatter(1, s_idx.to(I64),
                                                s_space - cnt)
    return comp_of, new_space


def _extra_pins(params: EnvParams, rng: _Rng, nn: torch.Tensor,
                net_open: torch.Tensor, extra_total: torch.Tensor
                ) -> torch.Tensor:
    """Extra pins of each net when ``max_ppn > min_ppn`` (the JAX kernel's
    :407-450, allocate_pins_to_nets:1067): weights softmax(N(1/nn,
    1/(net_distribution + 1))) over the open nets, a multinomial of the
    ``extra_total`` extra pins capped at ``max_ppn - min_ppn`` per net, and
    an in-order water-fill of the residue. Draws calls 7, 8 and 9 of the
    generator; returns i32 [B, N]."""
    N = params.max_num_nets
    span = params.max_num_pins_per_net - params.min_num_pins_per_net
    u1 = torch.maximum(rng.uniform(N), torch.tensor(1e-7, dtype=F32,
                                                    device=nn.device))
    u2 = rng.uniform(N)
    z = (_f64_rounded(torch.sqrt, -2.0 * _f64_rounded(torch.log, u1))
         * _f64_rounded(torch.cos, torch.full_like(u2, 6.2831853) * u2))
    # divisions by full tensors: CUDA divides by a scalar as a multiply by
    # its reciprocal, which rounds differently
    mean = torch.ones_like(z) / torch.clamp(nn, min=1).to(F32)
    s = mean + z / torch.full_like(z, params.net_distribution + 1.0)
    s = torch.where(net_open, s, torch.full_like(s, -1e9))
    e = _f64_rounded(torch.exp, s - s.max(1, keepdim=True).values)
    tot = e[:, 0:1]
    for c in range(1, N):              # in column order, as the kernel adds
        tot = tot + e[:, c:c + 1]
    probs = e / tot
    cprob = probs[:, 0:1]
    ut = rng.uniform(span * N)
    bint = torch.zeros(ut.shape, dtype=I32, device=ut.device)
    for c in range(N - 1):
        if c:
            cprob = cprob + probs[:, c:c + 1]
        bint = bint + (ut > cprob).to(I32)
    active = _iota(span * N, ut.device) < extra_total
    cnt = torch.stack([((bint == c) & active).sum(1, dtype=I32)
                       for c in range(N)], 1)
    caps = torch.where(net_open, torch.clamp(extra_total, max=span), 0)
    cnt = torch.minimum(cnt, caps)
    resid = extra_total - cnt.sum(1, keepdim=True, dtype=I32)
    before = torch.zeros_like(resid)
    cols = []
    for c in range(N):
        free_c = caps[:, c:c + 1] - cnt[:, c:c + 1]
        cols.append(cnt[:, c:c + 1] + torch.minimum(
            torch.clamp(resid - before, min=0), free_c))
        before = before + free_c
    return torch.cat(cols, 1)


def _generate(params: EnvParams, rng: _Rng, B: int, dev
              ) -> Tuple[torch.Tensor, ...]:
    """Fresh instances for every board, in ``_LEAVES`` order (the JAX
    kernel's in-kernel ``generate``, :363-601)."""
    C, N, M = (params.max_components, params.max_num_nets,
               params.max_num_pins_per_net)
    P, PPC = params.max_pins, params.max_num_pins_per_component
    ppn, max_ppn = params.min_num_pins_per_net, params.max_num_pins_per_net
    fgrid = torch.zeros((B, params.area), dtype=F32, device=dev)
    neg = torch.full((B, P), -1, dtype=I32, device=dev)
    no_pins = torch.zeros((B, 1), dtype=I32, device=dev)

    def fresh(comp_h, comp_w, numc, rel_x, rel_y, pin_net, pin_comp,
              num_pins):
        fp0, fp1 = _planes_for(
            params, fgrid, comp_h[:, 0:1], comp_w[:, 0:1],
            torch.ones((B, 1), dtype=torch.bool, device=dev))
        return (fgrid, comp_h, comp_w, torch.zeros_like(numc), numc,
                rel_x, rel_y, neg, neg, pin_net, pin_comp, num_pins, fp0, fp1)

    if params.variant == Variant.SQUARE:
        # unlimited supply of identical n x n components; draws nothing
        # (:364-377)
        comp = torch.full((B, C), params.component_n, dtype=I32, device=dev)
        numc = torch.full((B, 1), params.area, dtype=I32, device=dev)
        return fresh(comp, comp, numc, neg, neg, neg, neg, no_pins)

    comp_h = rng.randint(params.min_component_h, params.max_component_h, C)
    comp_w = rng.randint(params.min_component_w, params.max_component_w, C)
    numc = rng.randint(params.min_num_components, params.max_num_components,
                       1)
    cvalid = _iota(C, dev) < numc
    comp_h = torch.where(cvalid, comp_h, 0)
    comp_w = torch.where(cvalid, comp_w, 0)
    if not params.has_pins:
        # RECT: component sampling only, draws 2-4 (:379-397)
        return fresh(comp_h, comp_w, numc, neg, neg, neg, neg, no_pins)
    area = comp_h * comp_w
    total_area = area.sum(1, keepdim=True, dtype=I32)

    nn = rng.randint(params.min_num_nets, params.max_num_nets, 1)
    nn = torch.clamp(torch.minimum(nn, total_area // 2), min=1)
    # call 6: the total pin count (with min_ppn == max_ppn it feeds nothing,
    # but the draw keeps the JAX kernel's call numbering)
    tp = torch.minimum(rng.randint(ppn * nn, max_ppn * nn, 1), total_area)
    net_open = _iota(N, dev) < nn
    net_counts = torch.where(net_open, ppn, 0).to(I32)
    if max_ppn > ppn:
        net_counts = net_counts + _extra_pins(
            params, rng, nn, net_open, torch.clamp(tp - ppn * nn, min=0))
    num_pins = net_counts.sum(1, keepdim=True, dtype=I32)
    ncum = torch.cumsum(net_counts, 1, dtype=I32)
    iota_p = _iota(P, dev)
    pin_net = torch.zeros((B, P), dtype=I32, device=dev)
    for n in range(N):
        pin_net = pin_net + (iota_p >= ncum[:, n:n + 1]).to(I32)
    in_use = iota_p < num_pins
    start_of = torch.cat([torch.zeros_like(num_pins), ncum[:, :-1]], 1)
    rank_in_net = iota_p - _lane_gather(start_of,
                                        torch.clamp(pin_net, max=N - 1))

    if params.variant == Variant.PIN_SPATIAL:
        k0 = (params.pin_spread * numc) // 10 + 1
    else:
        k0 = torch.clamp(((params.pin_spread + 1) * numc) // 10, min=1)
    k0 = torch.minimum(k0, numc)

    space = area
    tables = []
    for n in range(N):
        comp_of, new_space = _allocate_net(params, rng, space,
                                           net_counts[:, n:n + 1], k0)
        tables.append(comp_of)
        space = torch.where(n < nn, new_space, space)
    gidx = (torch.clamp(pin_net, max=N - 1) * M
            + torch.clamp(rank_in_net, 0, M - 1))
    pin_comp = torch.where(in_use, _lane_gather(torch.cat(tables, 1), gidx),
                           -1)
    pin_net = torch.where(in_use, pin_net, -1)

    # distinct random cells per component (place_pins_on_component:1478):
    # a stable ascending sort of uniform scores, invalid cells scored 2.0
    scores = rng.uniform(C * PPC)
    cell_ids = _iota(C * PPC, dev) % PPC
    scores = torch.where(cell_ids < area.repeat_interleave(PPC, dim=1),
                         scores, torch.tensor(2.0, dtype=F32, device=dev))
    perms = []
    for c in range(C):
        sc = scores[:, c * PPC:(c + 1) * PPC]
        _, (_, perm) = _sort_desc_cols(
            -sc, [sc, _iota(PPC, dev).expand_as(sc)])
        perms.append(perm)
    cell_table = torch.cat(perms, 1)

    # rank of each pin within its component (table order)
    onehot = (pin_comp.unsqueeze(2) == _iota(C, dev).unsqueeze(0)).to(I32)
    before = torch.cumsum(onehot, 1, dtype=I32) - onehot
    rank_in_comp = (before * onehot).sum(2, dtype=I32)
    cidx = (torch.clamp(pin_comp, min=0) * PPC
            + torch.clamp(rank_in_comp, 0, PPC - 1))
    pcell = _lane_gather(cell_table, cidx)
    wp = _lane_gather(comp_w, torch.clamp(pin_comp, min=0))
    rel_x = torch.zeros_like(pcell)
    rel_y = torch.zeros_like(pcell)
    for wv in range(max(params.min_component_w, 1),
                    params.max_component_w + 1):
        rel_x = torch.where(wp == wv, pcell // wv, rel_x)
        rel_y = torch.where(wp == wv, pcell % wv, rel_y)
    used = pin_comp >= 0
    rel_x = torch.where(used, rel_x, -1)
    rel_y = torch.where(used, rel_y, -1)
    return fresh(comp_h, comp_w, numc, rel_x, rel_y, pin_net, pin_comp,
                 num_pins)


def _penalty(params: EnvParams) -> float:
    """Worst-case (invalid-action) reward, a host double (fused_rollout
    ``_build_kernel`` :303-311); 0 for SQUARE / RECT."""
    if not params.has_pins:
        return 0.0
    wl_norm = float(params.wirelength_normalizer)
    int_norm = float(params.intersections_normalizer)
    return -(float(params.weight_wirelength)
             * (params.max_wirelength / wl_norm)
             + float(params.weight_num_intersections)
             * (params.max_num_intersections / int_norm))


def _step(params: EnvParams, state: "list[torch.Tensor]", rng: _Rng,
          penalty: torch.Tensor):
    """One step of every board (the JAX kernel's ``body``, :604-735).
    Returns the next state and the f32 [B, 1] reward and bool done."""
    (grid, ch, cw, cur, numc, prx, pry, pax, pay, pnet, pcomp,
     npin, p0, p1) = state
    B, A = grid.shape
    W, C = params.width, params.max_components
    dev = grid.device
    zero = torch.zeros((), dtype=F32, device=dev)

    O = params.num_orientations
    c0 = p0.sum(1, keepdim=True)
    c1 = p1.sum(1, keepdim=True)
    if O == 1:                         # SQUARE: one plane
        total = c0
    elif O == 2:                       # RECT: two distinct planes
        total = c0 + c1
    else:                              # PIN: planes 2, 3 copy 0, 1 (:1866)
        total = 2.0 * (c0 + c1)
    alive = total > 0.0

    u = rng.uniform(1)
    tgt = torch.minimum(torch.floor(u * total), total - 1.0)
    tgt = torch.clamp(tgt, min=0.0)
    pre1 = c0
    if O == 1:
        osel = torch.zeros((B, 1), dtype=I32, device=dev)
        tin = tgt
    elif O == 2:
        osel = (tgt >= pre1).to(I32)
        tin = tgt - torch.where(osel == 0, zero, pre1)
    else:
        pre2 = c0 + c1
        pre3 = pre2 + c0
        osel = ((tgt >= pre1).to(I32) + (tgt >= pre2).to(I32)
                + (tgt >= pre3).to(I32))
        tin = tgt - torch.where(osel == 0, zero, torch.where(
            osel == 1, pre1, torch.where(osel == 2, pre2, pre3)))
    even = osel % 2 == 0
    plane = torch.where(even, p0, p1)
    idx = (torch.cumsum(plane, 1) <= tin).sum(1, keepdim=True, dtype=I32)
    idx = torch.clamp(idx, max=A - 1)
    xx = idx // W
    yy = idx % W

    chc = _lane_gather(ch, torch.clamp(cur, max=C - 1))
    cwc = _lane_gather(cw, torch.clamp(cur, max=C - 1))
    ph = torch.where(even, chc, cwc)
    pw = torch.where(even, cwc, chc)
    cell = _iota(A, dev)
    cell_x, cell_y = cell // W, cell % W
    ind = ((cell_x >= xx) & (cell_x < xx + ph)
           & (cell_y >= yy) & (cell_y < yy + pw))
    grid = torch.where(ind & alive, torch.ones((), dtype=F32, device=dev),
                       grid)

    if params.has_pins:
        # pin rotation (Component.place_component:156-204)
        mine = (pcomp == cur) & alive
        nrx = torch.where(osel == 0, prx, torch.where(
            osel == 1, pry, torch.where(osel == 2, chc - prx - 1,
                                        cwc - pry - 1)))
        nry = torch.where(osel == 0, pry, torch.where(
            osel == 1, chc - prx - 1, torch.where(osel == 2, cwc - pry - 1,
                                                  prx)))
        prx = torch.where(mine, nrx, prx)
        pry = torch.where(mine, nry, pry)
        pax = torch.where(mine, xx + prx, pax)
        pay = torch.where(mine, yy + pry, pay)

    cur = cur + alive.to(I32)
    placed_all = cur >= numc
    p0, p1 = _planes_for(params, grid,
                         _lane_gather(ch, torch.clamp(cur, max=C - 1)),
                         _lane_gather(cw, torch.clamp(cur, max=C - 1)),
                         ~placed_all)
    nt = 2.0 * (p0.sum(1, keepdim=True) + p1.sum(1, keepdim=True))
    done = placed_all | (nt == 0.0) | ~alive
    state = [grid, ch, cw, cur, numc, prx, pry, pax, pay, pnet, pcomp,
             npin, p0, p1]
    if params.has_pins:
        reward = torch.zeros((B, 1), dtype=F32, device=dev)
    else:
        # SQUARE / RECT: +1 per successful placement, terminal or not
        # (:711-713)
        reward = alive.to(F32)
    if bool(done.any()):
        # the JAX kernel's lax.cond(any(done)): route the post-placement
        # tables, then swap in the fresh instances
        if params.has_pins:
            routed = fused_routing.reward_rows(params, pax, pay, pnet, npin)
            reward = torch.where(done, torch.where(placed_all & alive,
                                                   routed, penalty), zero)
        fresh = _generate(params, rng, B, dev)
        state = [torch.where(done, f, s) for f, s in zip(fresh, state)]
    return state, reward, done


def rollout_chunk_reference(params: EnvParams,
                            leaves: Dict[str, torch.Tensor], seed: int,
                            num_steps: int, block: int
                            ) -> Tuple[Dict[str, torch.Tensor],
                                       torch.Tensor, torch.Tensor]:
    """The chunk in plain PyTorch, on the leaves' device.

    Returns ``(leaves', reward_sum_per_board f32[B], done_count_per_board
    i32[B])``; ``FusedRollout`` sums the two. Board ``b`` draws from the
    logical block ``b // block`` at row ``b % block``, as the JAX kernel's
    grid program ``b // block`` does.
    """
    state = [leaves[n] for n in _LEAVES]
    B = state[0].shape[0]
    dev = state[0].device
    board = torch.arange(B, dtype=I64, device=dev).view(B, 1)
    row, blk = board % block, board // block
    blk_salt = (int(seed) & _M32) ^ _mul32(blk, 0x9e3779b9)
    penalty = torch.tensor(_penalty(params), dtype=F32, device=dev)
    rsum = torch.zeros((B, 1), dtype=F32, device=dev)
    dcnt = torch.zeros((B, 1), dtype=I32, device=dev)
    for t in range(num_steps):
        rng = _Rng(blk_salt ^ ((t * 0x85ebca6b) & _M32), row)
        state, reward, done = _step(params, state, rng, penalty)
        rsum = rsum + reward
        dcnt = dcnt + done.to(I32)
    return dict(zip(_LEAVES, state)), rsum.view(B), dcnt.view(B)


# ---------------------------------------------------------------------------
# Leaves: the kernel's row-layout state
# ---------------------------------------------------------------------------

def leaf_widths(params: EnvParams) -> Dict[str, int]:
    """Row width of each leaf (the JAX wrapper's ``widths``, :842-849)."""
    a, c, p = params.area, params.max_components, params.max_pins
    return {"grid": a, "comp_h": c, "comp_w": c, "cursor": 1,
            "num_components": 1, "pin_rel_x": p, "pin_rel_y": p,
            "pin_abs_x": p, "pin_abs_y": p, "pin_net": p, "pin_comp": p,
            "num_pins": 1, "plane0": a, "plane1": a}


def _dtype(name: str) -> torch.dtype:
    return F32 if name in _FLOAT_LEAVES else I32


def zero_leaves(params: EnvParams, batch: int,
                device: Device) -> Dict[str, torch.Tensor]:
    """All-done zero boards (bench.py:125-133): the first step of a chunk
    finds no legal move on any board and replaces each with a generated
    instance, so no separate reset is needed."""
    return {n: torch.zeros((batch, w), dtype=_dtype(n), device=device)
            for n, w in leaf_widths(params).items()}


def init_leaves(params: EnvParams, gen: torch.Generator, batch: int,
                device: Device = "cuda") -> Dict[str, torch.Tensor]:
    """``batch`` fresh boards from the stepper's reset (``env/core.py``) in
    the kernel's row layout, on ``device`` (``gen`` a ``torch.Generator``
    there), the JAX ``init_leaves`` (:775-780). Raises without a card
    unless ``device`` is the CPU."""
    from placement_tpu_torch.env import core
    device = core.check_device(device, "init_leaves")
    return leaves_from_states(params, core.reset(params, gen, batch, device))


def leaves_from_states(params: EnvParams, states) -> Dict[str, torch.Tensor]:
    """A batched ``EnvState`` -> the kernel's row layout (reshapes and
    casts, JAX :783-806)."""
    b = states.batch
    mask = states.action_mask
    return {
        "grid": states.grid.reshape(b, -1).to(F32),
        "comp_h": states.comp_h.to(I32), "comp_w": states.comp_w.to(I32),
        "cursor": states.cursor.reshape(b, 1).to(I32),
        "num_components": states.num_components.reshape(b, 1).to(I32),
        "pin_rel_x": states.pin_rel_x.to(I32),
        "pin_rel_y": states.pin_rel_y.to(I32),
        "pin_abs_x": states.pin_abs_x.to(I32),
        "pin_abs_y": states.pin_abs_y.to(I32),
        "pin_net": states.pin_net.to(I32), "pin_comp": states.pin_comp.to(I32),
        "num_pins": states.num_pins.reshape(b, 1).to(I32),
        "plane0": mask[:, 0].reshape(b, -1).to(F32),
        # the square variant has one orientation plane; the kernel never
        # reads plane1 when num_orientations == 1
        "plane1": mask[:, min(1, mask.shape[1] - 1)].reshape(b, -1).to(F32),
    }


def leaves_from_numpy(arrays: Dict[str, np.ndarray],
                      device: Device) -> Dict[str, torch.Tensor]:
    """Leaves as numpy arrays (e.g. the JAX package's) -> the port's
    tensors: f32 grid/planes, i32 for the rest, ``[batch, width]``."""
    out = {}
    for n in _LEAVES:
        a = np.asarray(arrays[n])
        out[n] = torch.tensor(a.reshape(a.shape[0], -1), dtype=_dtype(n),
                              device=device)
    return out


def leaves_to_numpy(leaves: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {n: leaves[n].detach().cpu().numpy() for n in _LEAVES}


# ---------------------------------------------------------------------------
# What the port covers
# ---------------------------------------------------------------------------

def envelope_report(params: EnvParams) -> "tuple[bool, list]":
    """Check ``params`` against the kernel's fixed capacities
    (``KERNEL_CAPACITY``), split as the JAX ``envelope_report`` (:100-121)
    splits them: pin configs against the pin tables (and the beam width
    for the beam and "both" rewards), SQUARE / RECT against the board and
    ``components_nopin`` only. A board with one side over 32 is held to the
    area, and breaks that side's limit and the area's where it is over; one
    with both sides over 32 breaks both sides'. Returns ``(ok, reasons)``,
    one reason per violated limit."""
    sizes = {}
    if params.area > KERNEL_CAPACITY["area"]:
        sizes = {"height": params.height, "width": params.width}
        over = [k for k, v in sizes.items() if v > KERNEL_CAPACITY[k]]
        if len(over) == 1:
            sizes["area"] = params.area
    if params.has_pins:
        sizes.update({
            "components": params.max_components,
            "nets": params.max_num_nets,
            "pins_per_net": params.max_num_pins_per_net,
            "pins": params.max_pins,
            "pins_per_component": params.max_num_pins_per_component,
        })
        if params.reward_type in ("beam", "both"):
            sizes["beam_width"] = int(params.reward_beam_width)
    else:
        sizes["components_nopin"] = params.max_components
    reasons = [f"{k}={v} > {KERNEL_CAPACITY[k]}" for k, v in sizes.items()
               if v > KERNEL_CAPACITY[k]]
    return not reasons, reasons


def supports(params: EnvParams) -> bool:
    """Whether ``make_fused_rollout`` covers this configuration."""
    return envelope_report(params)[0]


def needs_general(params: EnvParams) -> bool:
    """Whether ``params`` runs the general instantiation of its kernel (a
    side over 32, or more nets or pins per net than the default one
    holds)."""
    sizes = {"height": params.height, "width": params.width}
    if params.has_pins:
        sizes.update(nets=params.max_num_nets,
                     pins_per_net=params.max_num_pins_per_net)
    return any(v > DEFAULT_CAPACITY[k] for k, v in sizes.items())


# ---------------------------------------------------------------------------
# The CUDA kernels' C interface (csrc/fused_rollout.cu, built by _build.py)
# ---------------------------------------------------------------------------

class _KernelParams(ctypes.Structure):
    """Mirror of ``FusedRolloutParams`` in csrc/fused_common.cuh."""

    _fields_ = [(n, ctypes.c_int32) for n in (
        "height", "width", "components", "nets", "pins_per_net", "pins",
        "pins_per_component", "min_h", "max_h", "min_w", "max_w",
        "min_c", "max_c", "min_n", "max_n", "ppn", "max_ppn", "spatial",
        "pin_spread")] + [(n, ctypes.c_float) for n in (
            "lam_w", "lam_i", "wl_norm", "int_norm", "penalty",
            "net_div")] + [
        (n, ctypes.c_int32) for n in (
            "kernel", "beam_width", "component_n", "general",
            "row_stride", "stride_recip")]


class _KernelLeaves(ctypes.Structure):
    """Mirror of ``FusedRolloutLeaves``: one device pointer per leaf."""

    _fields_ = [(n, ctypes.c_void_p) for n in _LEAVES]


def _row_stride(params: EnvParams) -> int:
    """The general instantiations' row stride (csrc/fused_warp.cuh, the
    flat layout): a row a lane where both sides fit one, a run of whole
    words for a row over 32 cells, rows end to end for a column over 32."""
    if params.width > 32:
        return 32 * -(-params.width // 32)
    return params.width if params.height > 32 else 32


def _kernel_params(params: EnvParams) -> _KernelParams:
    # ctypes rounds each host double to f32, as the JAX kernel's F32(...)
    stride = _row_stride(params)
    return _KernelParams(
        params.height, params.width, params.max_components,
        params.max_num_nets, params.max_num_pins_per_net, params.max_pins,
        params.max_num_pins_per_component,
        params.min_component_h, params.max_component_h,
        params.min_component_w, params.max_component_w,
        params.min_num_components, params.max_num_components,
        params.min_num_nets, params.max_num_nets,
        params.min_num_pins_per_net, params.max_num_pins_per_net,
        int(params.variant == Variant.PIN_SPATIAL), params.pin_spread,
        float(params.weight_wirelength),
        float(params.weight_num_intersections),
        float(params.wirelength_normalizer),
        float(params.intersections_normalizer), _penalty(params),
        params.net_distribution + 1.0, KERNELS.index(kernel_name(params)),
        int(params.reward_beam_width), params.component_n,
        int(needs_general(params)), stride, -(-(1 << 22) // stride))


#: seconds the process's first ``kernel_library()`` took (the
#: ``fused_rollout.library`` span's length, build included), None before it
_library_s: Optional[float] = None


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once per process;
    checks that its compiled capacities are ``KERNEL_CAPACITY``. The build
    or load is the span ``fused_rollout.library``, an nvcc build inside it
    ``fused_rollout.build``."""
    global _library_s
    from placement_tpu_torch.ops import _build
    t0 = time.perf_counter()
    with profiling.span("fused_rollout.library"):
        lib = load_kernel_library(_build.build()[0])
    _library_s = time.perf_counter() - t0
    return lib


def library_seconds() -> Optional[float]:
    """Seconds the kernel library's build or load took in this process,
    whether spans are on or off; None before ``kernel_library()``."""
    return _library_s


def load_kernel_library(path) -> ctypes.CDLL:
    """Load a built kernel library and declare its C entry points; checks
    that its compiled capacities are ``KERNEL_CAPACITY``."""
    lib = ctypes.CDLL(str(path))
    lib.fused_rollout_launch.restype = ctypes.c_int
    lib.fused_rollout_launch.argtypes = [
        ctypes.POINTER(_KernelParams), ctypes.POINTER(_KernelLeaves),
        ctypes.POINTER(_KernelLeaves), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_void_p]
    lib.fused_rollout_capacity.restype = ctypes.c_int
    lib.fused_rollout_capacity.argtypes = [ctypes.c_char_p]
    lib.fused_rollout_boards_per_sm.restype = ctypes.c_int
    lib.fused_rollout_boards_per_sm.argtypes = [
        ctypes.POINTER(_KernelParams)]
    got = {k: lib.fused_rollout_capacity(k.encode()) for k in KERNEL_CAPACITY}
    if got != KERNEL_CAPACITY:
        raise RuntimeError(f"kernel capacities {got} != {KERNEL_CAPACITY}")
    return lib


def boards_per_sm(params: EnvParams, general: bool) -> int:
    """How many boards one SM of the card holds at once in the pin kernel
    that runs ``params``, in its general instantiation or its default one
    (the CUDA runtime's occupancy of its block, 8 boards a block)."""
    kparams = _kernel_params(params)
    kparams.general = int(general)
    got = kernel_library().fused_rollout_boards_per_sm(ctypes.byref(kparams))
    if got < 0:
        raise RuntimeError(f"no occupancy for the {kernel_name(params)} "
                           "kernel")
    return got


class FusedRollout:
    """``fn(leaves, seed) -> (leaves', reward_sum, done_count)``.

    On leaves that lie on the CPU it runs ``rollout_chunk_reference``; on
    CUDA leaves it launches the CUDA kernel specialised for ``params``
    (``kernel``; its general instantiation where ``general``), or raises.
    ``launches`` counts kernel launches and nothing else. ``seed`` is a
    host int that must differ between calls.
    """

    def __init__(self, params: EnvParams, batch: int, num_steps: int,
                 block: int, device: Device):
        self.params = params
        self.batch = batch
        self.num_steps = num_steps
        self.block = block
        self.device = torch.device(device)
        self.widths = leaf_widths(params)
        self.kernel = kernel_name(params)
        self.general = needs_general(params)
        self.launches = 0
        self._kparams = _kernel_params(params)

    def per_board(self, leaves: Dict[str, torch.Tensor], seed: int
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                             torch.Tensor]:
        """The chunk with per-board ``f32[B]`` reward sums and ``i32[B]``
        done counts. The call is the span ``fused_rollout.per_board``, its
        leaf checks ``fused_rollout.check``."""
        with profiling.span("fused_rollout.per_board"):
            with profiling.span("fused_rollout.check"):
                self._check_leaves(leaves)
            dev = leaves["grid"].device
            if dev.type == "cpu":
                return rollout_chunk_reference(self.params, leaves, seed,
                                               self.num_steps, self.block)
            if dev.type != "cuda":
                raise ValueError(f"no fused rollout for device {dev}")
            return self._launch(leaves, seed)

    def __call__(self, leaves: Dict[str, torch.Tensor], seed: int
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                            torch.Tensor]:
        new, rsum, dcnt = self.per_board(leaves, seed)
        return new, torch.sum(rsum), torch.sum(dcnt)

    def _check_leaves(self, leaves: Dict[str, torch.Tensor]) -> None:
        for n in _LEAVES:
            t = leaves[n]
            if t.device.type != self.device.type or (
                    self.device.index is not None
                    and t.device.index != self.device.index):
                raise ValueError(f"leaf {n} on {t.device}, expected "
                                 f"{self.device}")
            if t.dtype != _dtype(n) or tuple(t.shape) != (
                    self.batch, self.widths[n]):
                raise ValueError(
                    f"leaf {n}: {t.dtype} {tuple(t.shape)}, expected "
                    f"{_dtype(n)} {(self.batch, self.widths[n])}")
            if not t.is_contiguous():
                raise ValueError(f"leaf {n} is not contiguous")

    def _launch(self, leaves: Dict[str, torch.Tensor], seed: int
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                           torch.Tensor]:
        """Spans: the outputs' allocation ``fused_rollout.alloc``; the
        pointer structs, the device guard, the stream and the C call that
        launches the kernel ``fused_rollout.launch``."""
        lib = kernel_library()
        dev = leaves["grid"].device
        with profiling.span("fused_rollout.alloc"):
            out = {n: torch.empty_like(leaves[n]) for n in _LEAVES}
            rsum = torch.empty(self.batch, dtype=F32, device=dev)
            dcnt = torch.empty(self.batch, dtype=I32, device=dev)
        with profiling.span("fused_rollout.launch"):
            ins = _KernelLeaves(*[leaves[n].data_ptr() for n in _LEAVES])
            outs = _KernelLeaves(*[out[n].data_ptr() for n in _LEAVES])
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                err = lib.fused_rollout_launch(
                    ctypes.byref(self._kparams), ctypes.byref(ins),
                    ctypes.byref(outs), rsum.data_ptr(), dcnt.data_ptr(),
                    self.batch, self.num_steps, self.block,
                    int(seed) & _M32, stream)
        if err != 0:
            raise RuntimeError(f"fused_rollout kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1
        return out, rsum, dcnt


def make_fused_rollout(params: EnvParams, batch: int, num_steps: int,
                       block: int = 128,
                       device: Device = "cuda") -> FusedRollout:
    """Build ``fn(leaves, seed) -> (leaves', reward_sum, done_count)``, the
    JAX ``make_fused_rollout`` contract (:809-887), for leaves on
    ``device``."""
    block = min(block, batch)
    ok, reasons = envelope_report(params)
    if not ok:
        raise ValueError("configuration outside the fused-kernel envelope "
                         f"({'; '.join(reasons)})")
    if batch % block:
        raise ValueError("batch must be divisible by block")
    return FusedRollout(params, batch, num_steps, block, device)
