"""Routing-based terminal reward on batches of boards (port of
``placement_tpu/env/routing.py``).

Reference subsystem: dummy_env_rectangular_pin.py:643-975 (centroid routing
route_pins_centroid:1296, beam search beam_search:1356 /
route_pins_beam_search:1425, crossings find_num_intersection:663 /
is_intersect:687, wirelength find_wirelength:741, find_reward:832).

All nets of all boards are routed at once on ``[B, N, M]`` pin tensors. The
float type of the routes is an argument, ``route_dtype``: ``torch.float32``
is the production path (the JAX module without x64); ``torch.float64`` is
the JAX module under ``jax.enable_x64``, the reference's own rounding, which
also switches the crossing count to the reference's float predicate
(``_pairwise_intersect_ref_float``). The reward is f32 either way.

Shared with ``ops/fused_routing.py`` (one definition each): the f32 rounding
rule of ``sqrt`` (``_f64_rounded``), the exact crossing predicate
(``_seg_intersect``) and the heap order of beam candidates (``_lex_less``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from placement_tpu_torch.env.types import EnvParams
from placement_tpu_torch.ops.fused_routing import (
    BIG, COORD_BASE, _f64_rounded, _lex_less, _seg_intersect)

F32 = torch.float32
F64 = torch.float64
I32 = torch.int32
I64 = torch.int64


def _sqrt_f64(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f64 square root of ``x >= 0``.

    PyTorch's CPU f64 ``sqrt`` is not correctly rounded (about 0.7% of
    inputs, small integers among them, come out one ulp off), and the x64
    parity path needs the reference's NumPy rounding: sums of route lengths
    that tie in real arithmetic must tie in f64 as they do there. Of the
    candidates ``y`` and its two neighbours, the one with the smallest exact
    residual ``|x - c*c|`` (``c*c`` split exactly by Veltkamp/Dekker) is
    taken; CUDA's ``sqrt`` is correctly rounded already, so there it keeps
    ``y``.
    """
    y = torch.sqrt(x)

    def residual(c: torch.Tensor) -> torch.Tensor:
        t = 134217729.0 * c                       # 2^27 + 1
        hi = t - (t - c)
        lo = c - hi
        p = c * c
        err = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo
        return ((x - p) - err).abs()

    best, best_r = y, residual(y)
    for toward in (0.0, float("inf")):
        c = torch.nextafter(y, torch.full_like(y, toward))
        r = residual(c)
        take = r < best_r
        best = torch.where(take, c, best)
        best_r = torch.where(take, r, best_r)
    return best


def _norm(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``sqrt(dx^2 + dy^2)`` (jnp.linalg.norm over the last axis of 2, and
    the wirelength's hypot): correctly rounded in the routes' float type."""
    s = dx * dx + dy * dy
    if s.dtype == F64:
        return _sqrt_f64(s)
    return _f64_rounded(torch.sqrt, s)


def net_pin_table(params: EnvParams, pin_abs_x: torch.Tensor,
                  pin_abs_y: torch.Tensor, pin_net: torch.Tensor,
                  dtype: torch.dtype = F32
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter the flat pin tables [B, P] into per-net positions.

    Returns (pos [B, N, M, 2] of ``dtype``, mask bool[B, N, M], counts
    i32[B, N]). Slot order within a net is pin-table order (the reference's
    net-grouped ``self.pins``, :1167-1169). Padding pins land in an overflow
    row and column that are cut off.
    """
    b, p = pin_net.shape
    n, m = params.max_num_nets, params.max_num_pins_per_net
    dev = pin_net.device
    valid = pin_net >= 0
    same = ((pin_net[:, None, :] == pin_net[:, :, None])
            & valid[:, None, :] & valid[:, :, None])
    rank = torch.tril(same.to(I32), diagonal=-1).sum(dim=2)
    net_idx = torch.where(valid, pin_net.to(I64), n)
    rank = torch.where(valid, rank.to(I64).clamp(0, m - 1), m)
    flat = net_idx * (m + 1) + rank                    # [B, P]

    pos = torch.zeros((b, (n + 1) * (m + 1), 2), dtype=dtype, device=dev)
    vals = torch.stack([pin_abs_x, pin_abs_y], dim=2).to(dtype)
    pos = pos.scatter(1, flat[:, :, None].expand(b, p, 2), vals)
    mask = torch.zeros((b, (n + 1) * (m + 1)), dtype=torch.bool, device=dev)
    mask = mask.scatter(1, flat, valid)
    pos = pos.view(b, n + 1, m + 1, 2)[:, :n, :m]
    mask = mask.view(b, n + 1, m + 1)[:, :n, :m]
    return pos, mask, mask.sum(dim=2, dtype=I32)


# ---------------------------------------------------------------------------
# Centroid routing (route_pins_centroid:1296-1324)
# ---------------------------------------------------------------------------

def centroid_route(pos: torch.Tensor, mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """Segments [B, N, M, 4], validity bool[B, N, M], the exact scaled form
    and its per-net scale [B, N].

    A net with exactly two pins is routed pin -> pin; otherwise every pin
    connects to the net centroid. ``seg_scaled[b, n] = seg[b, n] *
    scale[b, n]`` holds exact integer coordinates (the centroid sx/c stored
    as the coordinate sum sx), for the exact crossing predicate.
    """
    m = mask.shape[2]
    counts = mask.sum(dim=2)
    csum = torch.where(mask[..., None], pos, 0.0).sum(dim=2)   # [B, N, 2]
    denom = counts.clamp_min(1)[..., None].to(pos.dtype)
    centroid = csum / denom

    star = torch.cat([pos, centroid[:, :, None, :].expand_as(pos)], dim=3)
    star_scaled = torch.cat([pos * denom[:, :, :, None],
                             csum[:, :, None, :].expand_as(pos)], dim=3)
    direct = torch.cat([pos[:, :, 0], pos[:, :, 1]], dim=2)     # [B, N, 4]
    two = (counts == 2)[:, :, None]
    first = torch.arange(m, device=pos.device) == 0
    slot0 = two & first                                          # [B, N, M]
    seg = torch.where(two[..., None], 0.0, star)
    seg = torch.where(slot0[..., None], direct[:, :, None, :], seg)
    seg_scaled = torch.where(two[..., None], 0.0, star_scaled)
    seg_scaled = torch.where(slot0[..., None], direct[:, :, None, :],
                             seg_scaled)
    scale = torch.where(two[..., 0], 1, counts.clamp_min(1)).to(pos.dtype)
    seg_valid = torch.where(two, first, mask) & (counts > 0)[:, :, None]
    return seg, seg_valid, seg_scaled, scale


# ---------------------------------------------------------------------------
# Beam-search routing (beam_search:1356-1423)
# ---------------------------------------------------------------------------

def _point_key(pos: torch.Tensor) -> torch.Tensor:
    """Scalar order key per point equal to lexicographic (x, y) comparison
    for coordinates < 2^15 (heapq compares coordinate tuples when path
    priorities tie)."""
    return pos[..., 0] * COORD_BASE + pos[..., 1]


def _heap_order(cost: torch.Tensor, path_keys: torch.Tensor) -> torch.Tensor:
    """Indices [R, K] sorting each row's K candidates the way heapq pops
    (priority, path) tuples, as ``jnp.lexsort`` does in JAX: by cost, then
    the paths' point keys ``path_keys`` [R, K, L] lexicographically, ties
    in index order. Each candidate's position is the number of candidates
    ahead of it (``_lex_less`` over all pairs)."""
    r, k, length = path_keys.shape
    iota_l = torch.arange(length, device=cost.device)
    a_before_b = _lex_less(cost[:, :, None, None], path_keys[:, :, None, :],
                           cost[:, None, :, None], path_keys[:, None, :, :],
                           iota_l, length)[..., 0]               # [R, a, b]
    idx = torch.arange(k, device=cost.device)
    tie = ~a_before_b & ~a_before_b.transpose(1, 2)
    ahead = a_before_b | (tie & (idx[:, None] < idx[None, :]))
    position = ahead.sum(dim=1)                                  # [R, b]
    order = torch.empty((r, k), dtype=I64, device=cost.device)
    return order.scatter_(1, position, idx.expand(r, k).contiguous())


def beam_search_net(pos: torch.Tensor, mask: torch.Tensor, beam_width: int,
                    start: torch.Tensor) -> torch.Tensor:
    """Shortest pin-visiting path of each of R nets -> pin indices i32[R, M]
    (-1 past the net's pins).

    Each round, up to ``beam_width`` frontier paths each expand to their
    ``beam_width`` nearest unvisited pins (stable distance sort: ties by pin
    order, like the reference's ``sorted``), and the ``beam_width`` best new
    paths survive by (total distance, lexicographic coordinate path), the
    heapq order of beam_search:1356-1423. A net stops after ``count - 1``
    expansions; the loop runs ``M - 1`` rounds for every net.
    """
    r, m = mask.shape
    bw = beam_width
    if bw > m:
        raise ValueError(f"beam width {bw} wider than {m} pins per net")
    dev = pos.device
    count = mask.sum(dim=1)
    pkeys = _point_key(pos)                                      # [R, M]
    start = start.to(I64)
    rows_bw = torch.arange(bw, device=dev)
    iota_m = torch.arange(m, device=dev)

    paths = torch.full((r, bw, m), -1, dtype=I64, device=dev)
    paths[:, :, 0] = start[:, None]
    path_keys = torch.full((r, bw, m), -1.0, dtype=pos.dtype, device=dev)
    path_keys[:, :, 0] = pkeys.gather(1, start[:, None])
    visited = ((iota_m == start[:, None]) | ~mask)[:, None, :].expand(
        r, bw, m)
    cost = torch.where(rows_bw == 0, 0.0, BIG).to(pos.dtype).expand(r, bw)
    current = start[:, None].expand(r, bw)
    cand_parent = rows_bw.repeat_interleave(bw)                  # [bw * bw]

    for step in range(m - 1):
        head = pos.gather(1, current[:, :, None].expand(r, bw, 2))
        d = _norm(pos[:, None, :, 0] - head[:, :, None, 0],
                  pos[:, None, :, 1] - head[:, :, None, 1])      # [R, bw, M]
        d = torch.where(visited, BIG, d)
        nbr = torch.argsort(d, dim=2, stable=True)[:, :, :bw]    # [R, bw, bw]
        nbr_d = d.gather(2, nbr)

        cand_cost = (cost[:, :, None] + nbr_d).reshape(r, bw * bw)
        cand_pin = nbr.reshape(r, bw * bw)
        at = iota_m == step + 1
        cand_paths = torch.where(at, cand_pin[:, :, None],
                                 paths[:, cand_parent])
        cand_keys = torch.where(at, pkeys.gather(1, cand_pin)[:, :, None],
                                path_keys[:, cand_parent])
        cand_cost = torch.where(cand_cost >= BIG, BIG, cand_cost)

        keep = _heap_order(cand_cost, cand_keys)[:, :bw]         # [R, bw]
        new_current = cand_pin.gather(1, keep)
        new_visited = (visited.gather(1, cand_parent[keep][:, :, None]
                                      .expand(r, bw, m))
                       | (iota_m == new_current[:, :, None]))

        # freeze once the path is complete (count - 1 expansions done)
        active = ((step + 1) <= (count - 1))[:, None]
        paths = torch.where(active[..., None], cand_paths.gather(
            1, keep[:, :, None].expand(r, bw, m)), paths)
        path_keys = torch.where(active[..., None], cand_keys.gather(
            1, keep[:, :, None].expand(r, bw, m)), path_keys)
        visited = torch.where(active[..., None], new_visited, visited)
        cost = torch.where(active, cand_cost.gather(1, keep), cost)
        current = torch.where(active, new_current, current)

    # final heap pop: min (cost, lexicographic path)
    best = _heap_order(cost, path_keys)[:, 0]
    return paths.gather(1, best[:, None, None].expand(r, 1, m))[:, 0].to(I32)


def pin_outlier_index(pos: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Index [R] of each net's pin farthest from its centroid (pin_outlier
    :1326; np.argmax: the first maximum wins)."""
    count = mask.sum(dim=1)
    centroid = (torch.where(mask[..., None], pos, 0.0).sum(dim=1)
                / count.clamp_min(1)[:, None].to(pos.dtype))
    d = torch.where(mask, _norm(pos[..., 0] - centroid[:, None, 0],
                                pos[..., 1] - centroid[:, None, 1]), -1.0)
    return torch.argmax(d, dim=1)


def beam_route(params: EnvParams, pos: torch.Tensor, mask: torch.Tensor,
               beam_width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routes of all nets by beam search -> (segments [B, N, M-1, 4],
    validity bool[B, N, M-1])."""
    b, n, m = mask.shape
    flat_pos = pos.reshape(b * n, m, 2)
    flat_mask = mask.reshape(b * n, m)
    start = pin_outlier_index(flat_pos, flat_mask)
    path = beam_search_net(flat_pos, flat_mask, beam_width, start).to(I64)
    cnt = flat_mask.sum(dim=1)
    a, e = path[:, :-1], path[:, 1:]

    def at(idx: torch.Tensor) -> torch.Tensor:
        return flat_pos.gather(1, idx.clamp(0, m - 1)[..., None].expand(
            b * n, m - 1, 2))

    seg = torch.cat([at(a), at(e)], dim=2)
    seg_valid = ((torch.arange(m - 1, device=pos.device) < (cnt - 1)[:, None])
                 & (a >= 0) & (e >= 0))
    return seg.view(b, n, m - 1, 4), seg_valid.view(b, n, m - 1)


# ---------------------------------------------------------------------------
# Crossing count + wirelength (find_num_intersection:663, find_wirelength:741)
# ---------------------------------------------------------------------------

def _pairwise_intersect(seg_a: torch.Tensor, seg_b: torch.Tensor
                        ) -> torch.Tensor:
    """is_intersect (dummy_env_rectangular_pin.py:687-739) as exact
    orientation sign tests, broadcast over leading dims (the fused
    routing's ``_seg_intersect``)."""
    return _seg_intersect(*seg_a.unbind(-1), *seg_b.unbind(-1))


def _pairwise_intersect_ref_float(seg_a: torch.Tensor, seg_b: torch.Tensor
                                  ) -> torch.Tensor:
    """The reference's literal floating-point formulation (is_intersect
    :687-739): shared-endpoint equality, the det test, the division-based
    crossing point and an inclusive bounding-box check. The x64 path
    evaluates this on raw coordinates: the reference's f64 division can put
    a touching crossing just outside the box, and fixed-seed parity means
    reproducing that (JAX ``routing.py:277-314``)."""
    x1, y1, x2, y2 = seg_a.unbind(-1)
    x3, y3, x4, y4 = seg_b.unbind(-1)
    same = (((x1 == x3) & (y1 == y3)) | ((x1 == x4) & (y1 == y4))
            | ((x2 == x3) & (y2 == y3)) | ((x2 == x4) & (y2 == y4)))
    det = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    safe_det = torch.where(det == 0, 1.0, det)
    a = x1 * y2 - y1 * x2
    b = x3 * y4 - y3 * x4
    x = (a * (x3 - x4) - (x1 - x2) * b) / safe_det
    y = (a * (y3 - y4) - (y1 - y2) * b) / safe_det
    on_both = ((torch.minimum(x1, x2) <= x) & (x <= torch.maximum(x1, x2))
               & (torch.minimum(x3, x4) <= x) & (x <= torch.maximum(x3, x4))
               & (torch.minimum(y1, y2) <= y) & (y <= torch.maximum(y1, y2))
               & (torch.minimum(y3, y4) <= y) & (y <= torch.maximum(y3, y4)))
    return same | ((det != 0) & on_both)


def count_crossings(segs: torch.Tensor, seg_valid: torch.Tensor,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Intersecting cross-net segment pairs per board, i32[B].

    ``segs`` [B, N, S, 4], ``seg_valid`` bool[B, N, S]; each unordered pair
    of segments on different nets counted once (find_num_intersection
    :663-685). f64 segments take the reference's float predicate on raw
    coordinates; f32 ones the exact predicate, on integer-scaled
    coordinates when ``scale`` [B, N] is given (``centroid_route``'s
    ``seg_scaled``: each pair brought to the common frame scale_a * scale_b).
    """
    b, n, s, _ = segs.shape
    flat = segs.reshape(b, n * s, 4)
    valid = seg_valid.reshape(b, n * s)
    net = torch.arange(n, device=segs.device).repeat_interleave(s)
    if flat.dtype == F64:
        hit = _pairwise_intersect_ref_float(flat[:, :, None, :],
                                            flat[:, None, :, :])
    elif scale is None:
        hit = _pairwise_intersect(flat[:, :, None, :], flat[:, None, :, :])
    else:
        sc = scale.repeat_interleave(s, dim=1)                   # [B, N*S]
        hit = _pairwise_intersect(flat[:, :, None, :] * sc[:, None, :, None],
                                  flat[:, None, :, :] * sc[:, :, None, None])
    pair_ok = ((net[:, None] < net[None, :]) & valid[:, :, None]
               & valid[:, None, :])
    return (hit & pair_ok).sum(dim=(1, 2)).to(I32)


def wirelength(segs: torch.Tensor, seg_valid: torch.Tensor) -> torch.Tensor:
    """Total length of the valid segments per board."""
    d = _norm(segs[..., 0] - segs[..., 2], segs[..., 1] - segs[..., 3])
    return torch.where(seg_valid, d, 0.0).flatten(1).sum(dim=1)


# ---------------------------------------------------------------------------
# Reward composition (find_reward:832-975)
# ---------------------------------------------------------------------------

def terminal_reward(params: EnvParams, pin_abs_x: torch.Tensor,
                    pin_abs_y: torch.Tensor, pin_net: torch.Tensor,
                    placed_all: torch.Tensor,
                    route_dtype: torch.dtype = F32
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reward, info wirelength and info intersections, f32[B] each, for an
    episode end; routes computed in ``route_dtype``.

    ``placed_all`` False selects the worst-case penalty branch
    (find_reward:898-909): the raw upper bounds are surfaced in info while
    the reward uses their normalized values.
    """
    if route_dtype not in (F32, F64):
        raise ValueError(f"route_dtype must be float32 or float64, not "
                         f"{route_dtype}")
    wl_norm = params.wirelength_normalizer
    int_norm = params.intersections_normalizer
    lam_w = params.weight_wirelength
    lam_i = params.weight_num_intersections

    pos, mask, _ = net_pin_table(params, pin_abs_x, pin_abs_y, pin_net,
                                 route_dtype)
    if params.reward_type in ("centroid", "both"):
        c_segs, c_valid, c_scaled, c_scale = centroid_route(pos, mask)
        if route_dtype == F64:
            # the reference's f64 predicate on raw coordinates
            c_int = count_crossings(c_segs, c_valid)
        else:
            c_int = count_crossings(c_scaled, c_valid, c_scale)
        c_wl = wirelength(c_segs, c_valid)
    if params.reward_type in ("beam", "both"):
        b_segs, b_valid = beam_route(params, pos, mask,
                                     params.reward_beam_width)
        b_int = count_crossings(b_segs, b_valid)
        b_wl = wirelength(b_segs, b_valid)

    if params.reward_type == "centroid":
        n_int, wl = c_int, c_wl
    elif params.reward_type == "beam":
        n_int, wl = b_int, b_wl
    else:
        # fewest crossings wins; a tie takes the beam (routes[0]), :951-965
        use_beam = b_int <= c_int
        n_int = torch.where(use_beam, b_int, c_int)
        wl = torch.where(use_beam, b_wl, c_wl)

    # divisions by full tensors: CUDA divides by a host scalar as a
    # multiply by its reciprocal, which rounds differently from the CPU
    wl = wl / torch.full_like(wl, wl_norm)
    n_int_f = n_int.to(F32)
    n_int_f = n_int_f / torch.full_like(n_int_f, int_norm)
    routed = -(lam_w * wl + lam_i * n_int_f)
    penalty = -(lam_w * (params.max_wirelength / wl_norm)
                + lam_i * (params.max_num_intersections / int_norm))

    reward = torch.where(placed_all, routed, penalty)
    info_wl = torch.where(placed_all, wl, params.max_wirelength)
    info_int = torch.where(placed_all, n_int_f, torch.full_like(
        n_int_f, params.max_num_intersections))
    return reward.to(F32), info_wl.to(F32), info_int.to(F32)
