"""Routing rewards on ``[B, P]`` pin tables (port of
``placement_tpu/ops/fused_routing.py``).

These are the plain PyTorch bodies of the fused rollout's terminal reward.
``ops/fused_rollout.py::rollout_chunk_reference`` calls them; the CUDA
kernel (``ops/csrc/fused_rollout_warp.cu``) carries its own device-side copy of
the same arithmetic, and ``chip_smoke.py`` holds the two together.

  * ``centroid_wl_int`` — centroid star routing
    (route_pins_centroid, dummy_env_rectangular_pin.py:1296-1324)
  * ``beam_wl_int``     — heapq-order beam-search routing
    (beam_search:1356-1423 / route_pins_beam_search:1425-1476): stable
    nearest-neighbour expansion, (cost, lexicographic path) candidate
    ranking, first-wins ties
  * ``reward_rows``     — reward composition for all three reward types
    (find_reward:832-975; "both" takes the route with fewer crossings,
    tie -> beam, :951-965)

The arithmetic mirrors the JAX module operation for operation: coordinates
are small integers, so sums and squared distances are exact, ``sqrt`` is
correctly rounded (``_f64_rounded``) and the crossing predicate is exact.
The beam wirelength is accumulated in the JAX module's order (nets outer,
positions inner), so it is bit for bit the same; only the centroid
wirelength sums its lanes in another order.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from placement_tpu_torch.env.types import EnvParams

F32 = torch.float32
I32 = torch.int32
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


def _net_arrays(params: EnvParams, pax: torch.Tensor, pay: torch.Tensor,
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
    wl = torch.where(svalid,
                     _f64_rounded(torch.sqrt, dx * dx + dy * dy),
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
              cnt: torch.Tensor, bw: int, M: int
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
                     _f64_rounded(torch.sqrt, dx0 * dx0 + dy0 * dy0),
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
                            _f64_rounded(torch.sqrt, ddx * ddx + ddy * ddy))
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


def beam_wl_int(params: EnvParams, pax: torch.Tensor, pay: torch.Tensor,
                pnet: torch.Tensor, npin: torch.Tensor
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
        bx, by = _beam_net(xs[n], ys[n], present[n], cnt[n], bw, M)
        pxs = list(bx.split(1, dim=1))
        pys = list(by.split(1, dim=1))
        sv = [(t + 1) <= (cnt[n] - 1) for t in range(M - 1)]
        seg.append((pxs, pys, sv))
        for t in range(M - 1):
            dx = pxs[t] - pxs[t + 1]
            dy = pys[t] - pys[t + 1]
            wl = wl + torch.where(
                sv[t], _f64_rounded(torch.sqrt, dx * dx + dy * dy), zero)

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

def reward_rows(params: EnvParams, pax: torch.Tensor, pay: torch.Tensor,
                pnet: torch.Tensor, npin: torch.Tensor) -> torch.Tensor:
    """Routed terminal reward ``f32[B, 1]`` for any reward type.

    ``both`` takes the route with fewer crossings, tie -> beam
    (find_reward:951-965). The worst-case penalty branch lives in the
    rollout (reward_rows is only evaluated on placed-all episode ends).
    """
    if params.reward_type in ("centroid", "both"):
        c_wl, c_int = centroid_wl_int(params, pax, pay, pnet, npin)
    if params.reward_type in ("beam", "both"):
        b_wl, b_int = beam_wl_int(params, pax, pay, pnet, npin)

    if params.reward_type == "centroid":
        wl, ints = c_wl, c_int
    elif params.reward_type == "beam":
        wl, ints = b_wl, b_int
    else:
        use_beam = b_int <= c_int
        wl = torch.where(use_beam, b_wl, c_wl)
        ints = torch.where(use_beam, b_int, c_int)

    dev = wl.device
    lam_w = _f32(params.weight_wirelength).to(dev)
    wl_norm = _f32(params.wirelength_normalizer).to(dev)
    lam_i = _f32(params.weight_num_intersections).to(dev)
    int_norm = _f32(params.intersections_normalizer).to(dev)
    return -(lam_w * (wl / wl_norm) + lam_i * (ints / int_norm))
