"""The fused rollout chunk in plain PyTorch: the yardstick that decides
``correct``.

A frozen copy of the program's plain version of the chunk
(``placement_tpu_torch/ops/fused_rollout.py::rollout_chunk_reference``) and
of its plain routing rewards (``placement_tpu_torch/ops/fused_routing.py``),
with the environment's parameters (``Params``, a copy of the program's
``Params`` and its derived sizes). It imports nothing of the program, so
a change to the program cannot move it. Later changes to the program are
held to this copy; the benchmark's tests check that the two still agree.

One call, ``rollout_chunk(params, leaves, seed, num_steps, block)``, runs
``num_steps`` steps of every board under the random legal policy with
auto-reset: the action drawn from the legality planes, the placement and
its pin rotation, the next planes, the routing reward on episode end and
the regeneration of a fresh instance. Board ``b`` draws from the counter
hash under the logical block ``b // block`` at row ``b % block``, so each
board's stream is fixed by the seed, its index and the block, and boards
are independent.

``real`` is the precision of the routing reward's real arithmetic (the
distances' square roots, the wirelength sums and the reward's
composition): float32, as the configurations state, or bfloat16 for the
control that must come out not correct.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Dict, List, Tuple

import torch

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64
_M32 = 0xFFFFFFFF

#: the leaves of a chunk's state, in the kernel's order
LEAVES = ("grid", "comp_h", "comp_w", "cursor", "num_components",
          "pin_rel_x", "pin_rel_y", "pin_abs_x", "pin_abs_y",
          "pin_net", "pin_comp", "num_pins", "plane0", "plane1")
FLOATLEAVES = ("grid", "plane0", "plane1")


class Variant(enum.IntEnum):
    SQUARE = 0
    RECT = 1
    PIN = 2
    PIN_SPATIAL = 3


_VARIANTS = {"square": Variant.SQUARE, "rectangle": Variant.RECT,
             "rectangle_pin": Variant.PIN,
             "rectangle_spatial_pin": Variant.PIN_SPATIAL}


@dataclasses.dataclass(frozen=True)
class Params:
    """An environment's static parameters and derived sizes (the
    reference environment's constructor arguments)."""

    variant: Variant = Variant.PIN
    height: int = 10
    width: int = 10
    component_n: int = 2
    min_component_w: int = 2
    max_component_w: int = 2
    min_component_h: int = 2
    max_component_h: int = 2
    min_num_components: int = 5
    max_num_components: int = 5
    net_distribution: int = 9
    pin_spread: int = 9
    min_num_nets: int = 3
    max_num_nets: int = 3
    min_num_pins_per_net: int = 2
    max_num_pins_per_net: int = 6
    reward_type: str = "both"
    reward_beam_width: int = 2
    weight_wirelength: float = 0.5
    weight_num_intersections: float = 0.5

    @classmethod
    def from_env_config(cls, env_config: Dict[str, Any],
                        **overrides: Any) -> "Params":
        """A configuration's ``env_config`` block (the reference's schema),
        with ``overrides`` (a traffic mix's reward) applied."""
        cfg = {**env_config, **overrides}
        variant = _VARIANTS[cfg.pop("type", "rectangle_pin")]
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(variant=variant,
                   **{k: v for k, v in cfg.items() if k in names})

    @property
    def area(self) -> int:
        return self.height * self.width

    @property
    def num_orientations(self) -> int:
        return {Variant.SQUARE: 1, Variant.RECT: 2}.get(self.variant, 4)

    @property
    def max_components(self) -> int:
        return 1 if self.variant == Variant.SQUARE else self.max_num_components

    @property
    def max_num_pins_per_component(self) -> int:
        return self.max_component_h * self.max_component_w

    @property
    def max_pins(self) -> int:
        if not self.has_pins:
            return 1
        return self.max_num_nets * self.max_num_pins_per_net

    @property
    def has_pins(self) -> bool:
        return self.variant in (Variant.PIN, Variant.PIN_SPATIAL)

    @property
    def max_wirelength(self) -> float:
        dist = math.hypot(float(self.height), float(self.width))
        total = 0.5 * dist * (self.max_num_nets * self.max_num_pins_per_net)
        if self.variant == Variant.PIN_SPATIAL:
            return total / (self.height + self.width)
        return total

    @property
    def max_num_intersections(self) -> float:
        v = (0.5 * self.max_num_pins_per_net ** 2
             * self.max_num_nets * (self.max_num_nets - 1))
        if self.variant == Variant.PIN_SPATIAL:
            return v
        return float(int(v))

    @property
    def intersections_normalizer(self) -> float:
        avg_by_comp = (0.5 * (self.min_component_h + self.max_component_h)
                       * 0.5 * (self.min_component_w + self.max_component_w)
                       * 0.5 * (self.min_num_components
                                + self.max_num_components))
        avg_by_net = (0.5 * (self.min_num_pins_per_net
                             + self.max_num_pins_per_net)
                      * 0.5 * (self.min_num_nets + self.max_num_nets))
        return min(avg_by_comp, avg_by_net)

    @property
    def wirelength_normalizer(self) -> float:
        return float(self.height + self.width)


def leaf_widths(params: Params) -> Dict[str, int]:
    """Row width of each leaf."""
    a, c, p = params.area, params.max_components, params.max_pins
    return {"grid": a, "comp_h": c, "comp_w": c, "cursor": 1,
            "num_components": 1, "pin_rel_x": p, "pin_rel_y": p,
            "pin_abs_x": p, "pin_abs_y": p, "pin_net": p, "pin_comp": p,
            "num_pins": 1, "plane0": a, "plane1": a}


def kernel_name(params: Params) -> str:
    if params.variant == Variant.SQUARE:
        return "square"
    if params.variant == Variant.RECT:
        return "rect"
    return params.reward_type


# ---------------------------------------------------------------------------
# Routing rewards on [B, P] pin tables
# ---------------------------------------------------------------------------

BIG = 1e9          # dead-path cost, routing.BIG
INF2 = 2e9         # "already selected" marker, must exceed BIG
COORD_BASE = float(1 << 15)  # routing._COORD_BASE (point keys exact in f32)


def _f32(v: float) -> torch.Tensor:
    """A host double rounded to f32 (the JAX module's ``F32(float(v))``)."""
    return torch.tensor(float(v), dtype=F32)


def _f64_rounded(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of f32 ``x`` evaluated in f64 and rounded to f32: the one
    rounding rule of the port's ``sqrt``, ``log``, ``cos`` and ``exp``,
    which the CUDA kernel follows too, so the plain version on any device
    and the kernel give the same bits.

    PyTorch's vectorised f32 ``sqrt`` on the CPU is not correctly rounded
    (about 0.6% of inputs come out one ulp off), which can flip the
    outlier-pin choice of a beam route; nor are XLA's, PyTorch's and CUDA's
    f32 ``log``/``cos``/``exp``. The f64 result rounded to f32 is correctly
    rounded (in practice), as XLA's and CUDA's ``sqrtf`` are.
    """
    return fn(x.double()).to(F32)


def _root(v: torch.Tensor, real: torch.dtype) -> torch.Tensor:
    """A distance's square root, correctly rounded to ``real`` and held in
    f32 (in f32 it is ``_f64_rounded(torch.sqrt, v)``)."""
    return torch.sqrt(v.double()).to(real).to(F32)


def _net_arrays(params: Params, pax: torch.Tensor, pay: torch.Tensor,
                pnet: torch.Tensor, npin: torch.Tensor
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                           List[torch.Tensor], List[torch.Tensor]]:
    """Split the net-grouped pin table into per-net [B, M] rank arrays.

    Returns ``(xs, ys, present, cnt)`` lists over nets: ``xs[n][:, j]`` is
    the f32 x of net ``n``'s j-th pin (table order), 0 where there is none;
    ``present[n]`` bool[B, M]; ``cnt[n]`` i32[B, 1] pin count.
    """
    B, P = pax.shape
    N, M = params.max_num_nets, params.max_num_pins_per_net
    dev = pax.device
    iota = torch.arange(P, dtype=I32, device=dev).view(1, P)
    iota_m = torch.arange(M, dtype=I32, device=dev).view(1, M)
    in_use = iota < npin
    x = pax.to(F32)
    y = pay.to(F32)
    zero = torch.zeros((), dtype=F32, device=dev)

    xs, ys, present, cnt = [], [], [], []
    start = torch.zeros((B, 1), dtype=I32, device=dev)
    for n in range(N):
        mn = (pnet == n) & in_use
        c = mn.sum(dim=1, keepdim=True, dtype=I32)
        rin = iota - start
        # at most one lane of the net has rank j, so the JAX module's
        # masked sum is that lane's value
        hit = mn.unsqueeze(2) & (rin.unsqueeze(2) == iota_m.unsqueeze(1))
        xs.append(torch.where(hit, x.unsqueeze(2), zero).sum(dim=1))
        ys.append(torch.where(hit, y.unsqueeze(2), zero).sum(dim=1))
        present.append(iota_m < c)
        cnt.append(c)
        start = start + c
    return xs, ys, present, cnt


# ---------------------------------------------------------------------------
# Centroid routing (route_pins_centroid:1296-1324) on row tables
# ---------------------------------------------------------------------------

def centroid_wl_int(params: Params, pax: torch.Tensor, pay: torch.Tensor,
                    pnet: torch.Tensor, npin: torch.Tensor,
                    real: torch.dtype = F32
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
    wl = torch.where(svalid, _root(dx * dx + dy * dy, real),
                     zero).to(real).sum(dim=1, keepdim=True).to(F32)
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


# ---------------------------------------------------------------------------
# Beam-search routing (beam_search:1356-1423) on row tables
# ---------------------------------------------------------------------------

def _first_where(cond: torch.Tensor, iota_m: torch.Tensor,
                 M: int) -> torch.Tensor:
    """Lowest lane index (last dim) where ``cond`` holds (M if none), kept
    as a size-1 last dim. Replicates argsort/argmax first-wins
    tie-breaking."""
    return torch.where(cond, iota_m, M).amin(dim=-1, keepdim=True)


def _at(arr: torch.Tensor, idx: torch.Tensor,
        iota_m: torch.Tensor) -> torch.Tensor:
    """arr[..., idx] over the last dim, kept as a size-1 last dim (idx < M;
    0.0 if idx == M)."""
    return torch.where(iota_m == idx, arr,
                       torch.zeros((), dtype=arr.dtype, device=arr.device)
                       ).sum(dim=-1, keepdim=True)


def _lex_less(cost_a, pk_a, cost_b, pk_b, iota_m, M: int) -> torch.Tensor:
    """Heap ordering (routing._heap_order): (cost, path point keys
    lexicographically from position 0, the last dim; leading dims
    broadcast). Strict less — equal candidates compare False, so iteration
    order supplies lexsort's stability. ``env/routing.py::_heap_order``
    ranks all candidate pairs by it."""
    pos = _first_where(pk_a != pk_b, iota_m, M)
    va = _at(pk_a, pos, iota_m)
    vb = _at(pk_b, pos, iota_m)
    lt = (pos < M) & (va < vb)
    return (cost_a < cost_b) | ((cost_a == cost_b) & lt)


def _beam_net(xs: torch.Tensor, ys: torch.Tensor, present: torch.Tensor,
              cnt: torch.Tensor, bw: int, M: int, real: torch.dtype = F32
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-search path for one net -> position arrays ``(px, py)`` f32[B,M].

    Consecutive path positions are the route segments, valid while
    ``t + 1 <= cnt - 1``. Same distance formulas, stable nearest-neighbour
    order, (cost, lexicographic path) candidate ranking, first-wins ties and
    per-board freezing after ``cnt - 1`` expansions as the JAX module.
    """
    B = cnt.shape[0]
    dev = xs.device
    iota_m = torch.arange(M, dtype=I32, device=dev).view(1, M)
    zero = torch.zeros((), dtype=F32, device=dev)

    # start = pin farthest from the net centroid (pin_outlier:1326;
    # np.argmax -> first max wins ties); a net without pins starts at lane 0
    denom = torch.clamp(cnt, min=1).to(F32)
    cx = torch.where(present, xs, zero).sum(dim=1, keepdim=True) / denom
    cy = torch.where(present, ys, zero).sum(dim=1, keepdim=True) / denom
    dx0 = xs - cx
    dy0 = ys - cy
    d0 = torch.where(present,
                     _root(dx0 * dx0 + dy0 * dy0, real),
                     torch.tensor(-1.0, dtype=F32, device=dev))
    dmax = d0.amax(dim=1, keepdim=True)
    start = _first_where(d0 == dmax, iota_m, M)
    sx = _at(xs, start, iota_m)
    sy = _at(ys, start, iota_m)
    skey = sx * COORD_BASE + sy

    at0 = iota_m == 0
    cost = [torch.full((B, 1), 0.0 if k == 0 else BIG, dtype=F32,
                       device=dev) for k in range(bw)]
    curx = [sx] * bw
    cury = [sy] * bw
    vis = [(iota_m == start) | ~present] * bw
    pk = [torch.where(at0, skey, torch.tensor(-1.0, dtype=F32,
                                              device=dev))] * bw
    px = [torch.where(at0, sx, zero)] * bw
    py = [torch.where(at0, sy, zero)] * bw
    big = torch.tensor(BIG, dtype=F32, device=dev)
    inf2 = torch.tensor(INF2, dtype=F32, device=dev)

    for step in range(M - 1):
        at_new = iota_m == step + 1
        # candidates: parent-major, nearest-neighbour-minor — the candidate
        # order of beam_search_net's reshape, so first-wins selection
        # below reproduces lexsort's stability
        cand = []
        for k in range(bw):
            ddx = xs - curx[k]
            ddy = ys - cury[k]
            d = torch.where(vis[k], big,
                            _root(ddx * ddx + ddy * ddy, real))
            taken = torch.zeros((B, M), dtype=torch.bool, device=dev)
            for _c in range(bw):
                eff = torch.where(taken, inf2, d)
                m = eff.amin(dim=1, keepdim=True)
                j = _first_where(eff == m, iota_m, M)
                taken = taken | (iota_m == j)
                nx = _at(xs, j, iota_m)
                ny = _at(ys, j, iota_m)
                ccost = cost[k] + torch.where(m >= INF2, big, m)
                ccost = torch.where(ccost >= BIG, big, ccost)
                nkey = nx * COORD_BASE + ny
                cand.append(dict(
                    cost=ccost,
                    pk=torch.where(at_new, nkey, pk[k]),
                    px=torch.where(at_new, nx, px[k]),
                    py=torch.where(at_new, ny, py[k]),
                    vis=vis[k] | (iota_m == j),
                    cx=nx, cy=ny))

        # keep the bw best candidates in heap order (first-wins ties)
        active = (step + 1) <= (cnt - 1)
        ctaken = [torch.zeros((B, 1), dtype=torch.bool, device=dev)
                  for _ in cand]
        ncost, ncurx, ncury = list(cost), list(curx), list(cury)
        nvis, npk, npx, npy = list(vis), list(pk), list(px), list(py)
        for k in range(bw):
            sel = dict(cand[0])
            sel_i = torch.full((B, 1), -1, dtype=I32, device=dev)
            seen = torch.zeros((B, 1), dtype=torch.bool, device=dev)
            for i, c in enumerate(cand):
                take = ~ctaken[i] & (
                    ~seen | _lex_less(c["cost"], c["pk"], sel["cost"],
                                      sel["pk"], iota_m, M))
                sel = {f: torch.where(take, c[f], sel[f]) for f in sel}
                sel_i = torch.where(take, i, sel_i)
                seen = seen | ~ctaken[i]
            for i in range(len(cand)):
                ctaken[i] = ctaken[i] | (sel_i == i)
            # freeze finished boards (cnt - 1 expansions done)
            ncost[k] = torch.where(active, sel["cost"], cost[k])
            npk[k] = torch.where(active, sel["pk"], pk[k])
            npx[k] = torch.where(active, sel["px"], px[k])
            npy[k] = torch.where(active, sel["py"], py[k])
            nvis[k] = torch.where(active, sel["vis"], vis[k])
            ncurx[k] = torch.where(active, sel["cx"], curx[k])
            ncury[k] = torch.where(active, sel["cy"], cury[k])
        cost, curx, cury = ncost, ncurx, ncury
        vis, pk, px, py = nvis, npk, npx, npy

    # final heap pop: min (cost, lexicographic path), first wins
    bcost, bkeys, bx, by = cost[0], pk[0], px[0], py[0]
    for k in range(1, bw):
        better = _lex_less(cost[k], pk[k], bcost, bkeys, iota_m, M)
        bcost = torch.where(better, cost[k], bcost)
        bkeys = torch.where(better, pk[k], bkeys)
        bx = torch.where(better, px[k], bx)
        by = torch.where(better, py[k], by)
    return bx, by


def beam_wl_int(params: Params, pax: torch.Tensor, pay: torch.Tensor,
                pnet: torch.Tensor, npin: torch.Tensor,
                real: torch.dtype = F32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-route wirelength and crossing count, ``([B,1] f32) * 2``.

    Every net (2-pin nets included) is routed by beam search from its
    outlier pin; segments are consecutive path positions, ``cnt - 1`` per
    net. Endpoints are raw integer pin coordinates, so the crossing
    predicate is exact with no scaling. The wirelength is added one
    ``[B, 1]`` term at a time, nets outer and positions inner, as the JAX
    module adds it.
    """
    B = pax.shape[0]
    N, M = params.max_num_nets, params.max_num_pins_per_net
    bw = int(params.reward_beam_width)
    dev = pax.device
    xs, ys, present, cnt = _net_arrays(params, pax, pay, pnet, npin)
    zero = torch.zeros((), dtype=F32, device=dev)

    seg = []   # per net: (x[t], y[t] [B,1] lists of length M, valid[t])
    wl = torch.zeros((B, 1), dtype=F32, device=dev)
    for n in range(N):
        bx, by = _beam_net(xs[n], ys[n], present[n], cnt[n], bw, M, real)
        pxs = list(bx.split(1, dim=1))
        pys = list(by.split(1, dim=1))
        sv = [(t + 1) <= (cnt[n] - 1) for t in range(M - 1)]
        seg.append((pxs, pys, sv))
        for t in range(M - 1):
            dx = pxs[t] - pxs[t + 1]
            dy = pys[t] - pys[t + 1]
            wl = (wl + torch.where(
                sv[t], _root(dx * dx + dy * dy, real), zero)).to(real).to(F32)

    ints = torch.zeros((B, 1), dtype=F32, device=dev)
    for n1 in range(N):
        ax, ay, av = seg[n1]
        for n2 in range(n1 + 1, N):
            bx, by, bv = seg[n2]
            for t1 in range(M - 1):
                for t2 in range(M - 1):
                    hit = _seg_intersect(
                        ax[t1], ay[t1], ax[t1 + 1], ay[t1 + 1],
                        bx[t2], by[t2], bx[t2 + 1], by[t2 + 1])
                    ints = ints + (hit & av[t1] & bv[t2]).to(F32)
    return wl, ints


# ---------------------------------------------------------------------------
# Reward composition (find_reward:832-975)
# ---------------------------------------------------------------------------

def reward_rows(params: Params, pax: torch.Tensor, pay: torch.Tensor,
                pnet: torch.Tensor, npin: torch.Tensor,
                real: torch.dtype = F32) -> torch.Tensor:
    """Routed terminal reward ``f32[B, 1]`` for any reward type.

    ``both`` takes the route with fewer crossings, tie -> beam
    (find_reward:951-965). The worst-case penalty branch lives in the
    rollout (reward_rows is only evaluated on placed-all episode ends).
    """
    if params.reward_type in ("centroid", "both"):
        c_wl, c_int = centroid_wl_int(params, pax, pay, pnet, npin, real)
    if params.reward_type in ("beam", "both"):
        b_wl, b_int = beam_wl_int(params, pax, pay, pnet, npin, real)

    if params.reward_type == "centroid":
        wl, ints = c_wl, c_int
    elif params.reward_type == "beam":
        wl, ints = b_wl, b_int
    else:
        use_beam = b_int <= c_int
        wl = torch.where(use_beam, b_wl, c_wl)
        ints = torch.where(use_beam, b_int, c_int)

    dev = wl.device
    lam_w, wl_norm, lam_i, int_norm = (
        _f32(v).to(dev, real) for v in (
            params.weight_wirelength, params.wirelength_normalizer,
            params.weight_num_intersections,
            params.intersections_normalizer))
    wl, ints = wl.to(real), ints.to(real)
    return (-(lam_w * (wl / wl_norm) + lam_i * (ints / int_norm))).to(F32)


# ---------------------------------------------------------------------------
# The chunk on [B, F] rows
# ---------------------------------------------------------------------------

def _combos(params: Params) -> "list[tuple[int, int]]":
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


def _planes_for(params: Params, grid: torch.Tensor, ch_c: torch.Tensor,
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


def _allocate_net(params: Params, rng: _Rng, space, m, k0):
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


def _extra_pins(params: Params, rng: _Rng, nn: torch.Tensor,
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


def _generate(params: Params, rng: _Rng, B: int, dev
              ) -> Tuple[torch.Tensor, ...]:
    """Fresh instances for every board, in ``LEAVES`` order (the JAX
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


def _penalty(params: Params) -> float:
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


def _step(params: Params, state: "list[torch.Tensor]", rng: _Rng,
          penalty: torch.Tensor, real: torch.dtype = F32):
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
            routed = reward_rows(params, pax, pay, pnet, npin, real)
            reward = torch.where(done, torch.where(placed_all & alive,
                                                   routed, penalty), zero)
        fresh = _generate(params, rng, B, dev)
        state = [torch.where(done, f, s) for f, s in zip(fresh, state)]
    return state, reward, done


def rollout_chunk(params: Params, leaves: Dict[str, torch.Tensor],
                  seed: int, num_steps: int, block: int,
                  real: torch.dtype = F32
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                             torch.Tensor]:
    """The chunk in plain PyTorch, on the leaves' device.

    Returns ``(leaves', reward_sum_per_board f32[B], done_count_per_board
    i32[B])``. Board ``b`` draws from the logical block ``b // block`` at
    row ``b % block``.
    """
    state = [leaves[n] for n in LEAVES]
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
        state, reward, done = _step(params, state, rng, penalty, real)
        rsum = rsum + reward
        dcnt = dcnt + done.to(I32)
    return dict(zip(LEAVES, state)), rsum.view(B), dcnt.view(B)


