"""The beam and "both" routing rewards in plain PyTorch for boards of many
pins: the yardstick that decides ``correct`` in the cells of the
``fused_wide_beam`` engine.

``portbench/reference.py``'s ``beam_wl_int`` routes one net at a time,
keeps each new beam by comparing every candidate's path with the best so
far, position by position, and tests the routed segments' crossings one
pair of path positions at a time (one ``_seg_intersect`` for each net pair
and position pair). Each is a host call on the card: on 10 nets of 10 pins
at beam width 4 that is tens of thousands of calls a reward. This file
computes the same function, bit for bit, in fewer, wider operations:

  * every net at once, on ``[B * N, M]`` tables of each net's pin ranks,
    and every beam's candidates at once (``[B * N, bw, M]``);
  * the bw best of the bw * bw candidates by one stable sort of their keys
    (the cost, then the path's point keys position by position, the most
    significant last): the order in which the frozen reference's
    first-wins selection takes them;
  * the crossings as one test of every pair of routed segments on
    different nets, ``[B, N (M - 1), N (M - 1)]``, the lower net's segment
    first, in the same integer frame as ``_seg_intersect``;
  * the wirelength added one ``[B, 1]`` term at a time, nets outer and
    positions inner, rounded to ``real`` after each addition, as the frozen
    reference adds it.

Its ``reward_rows`` is the frozen reference's composition of the routes,
with this beam route and ``reference_wide``'s centroid route; its
``rollout_chunk`` is ``reference_wide.rollout_chunk`` (the allocation,
generator and centroid route in wide operations) with that
``reward_rows``. Both are the imported functions' own code, given these
routes by name (``rebind``). Like them, this file imports nothing of the
program, so a change to the program cannot move it.
"""

from __future__ import annotations

import types
from typing import Tuple

import torch

from portbench import reference, reference_wide
from portbench.reference import (BIG, COORD_BASE, F32, I32, INF2, Params,
                                 _at, _first_where, _iota, _root,
                                 _seg_intersect)


def rebind(fn, **names):
    """``fn``, the same code, with ``names`` in place of the module
    globals of those names that it reads."""
    got = types.FunctionType(fn.__code__, {**fn.__globals__, **names},
                             fn.__name__, fn.__defaults__, fn.__closure__)
    got.__doc__ = fn.__doc__
    return got


def _net_tables(params: Params, pax: torch.Tensor, pay: torch.Tensor,
                pnet: torch.Tensor, npin: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each net's pins by rank (``reference._net_arrays`` for all nets at
    once): f32 ``[B, N, M]`` x and y of net n's rank j, the pin at table
    position start_n + j where it is net n's (0 where there is none), and
    its i32 ``[B, N, 1]`` pin counts."""
    B, P = pax.shape
    N, M = params.max_num_nets, params.max_num_pins_per_net
    dev = pax.device
    mine = ((pnet.unsqueeze(1) == _iota(N, dev).view(1, N, 1))
            & (_iota(P, dev) < npin).unsqueeze(1))          # [B, N, P]
    cnt = mine.sum(2, keepdim=True, dtype=I32)
    start = torch.cumsum(cnt, 1, dtype=I32) - cnt
    pos = start + _iota(M, dev).view(1, 1, M)                # [B, N, M]
    at = torch.clamp(pos, max=P - 1).long()
    hit = (pos < P) & torch.gather(mine, 2, at)
    zero = torch.zeros((), dtype=F32, device=dev)

    def coord(v):
        return torch.where(hit, torch.gather(
            v.to(F32).unsqueeze(1).expand(B, N, P), 2, at), zero)
    return coord(pax), coord(pay), cnt


def _stable_order(keys: "list[torch.Tensor]") -> torch.Tensor:
    """The permutation that sorts the last dim by ``keys`` (most
    significant first), ties in index order: stable sorts by each key in
    turn, the least significant first."""
    order = torch.arange(keys[0].shape[-1], device=keys[0].device
                         ).expand(keys[0].shape)
    for key in reversed(keys):
        by = torch.sort(torch.gather(key, -1, order), dim=-1,
                        stable=True).indices
        order = torch.gather(order, -1, by)
    return order


def _beam_nets(xs: torch.Tensor, ys: torch.Tensor, cnt: torch.Tensor,
               bw: int, M: int, real: torch.dtype
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``reference._beam_net`` on R rows at once (``xs``, ``ys`` f32
    ``[R, M]``, ``cnt`` i32 ``[R, 1]``): the best beam's path positions,
    f32 ``[R, M]`` each. The beams are a dim of their own, ``[R, bw]``
    (their paths ``[R, bw, M]``); the candidates of beam k are k * bw + c
    for its c-th nearest pin."""
    R = cnt.shape[0]
    dev = xs.device
    iota_m = torch.arange(M, dtype=I32, device=dev).view(1, M)
    iota3 = iota_m.view(1, 1, M)
    zero = torch.zeros((), dtype=F32, device=dev)
    big = torch.tensor(BIG, dtype=F32, device=dev)
    inf2 = torch.tensor(INF2, dtype=F32, device=dev)
    present = iota_m < cnt

    # start: the pin farthest from the net centroid, first wins
    denom = torch.clamp(cnt, min=1).to(F32)
    cx = torch.where(present, xs, zero).sum(dim=1, keepdim=True) / denom
    cy = torch.where(present, ys, zero).sum(dim=1, keepdim=True) / denom
    dx0 = xs - cx
    dy0 = ys - cy
    d0 = torch.where(present, _root(dx0 * dx0 + dy0 * dy0, real),
                     torch.tensor(-1.0, dtype=F32, device=dev))
    dmax = d0.amax(dim=1, keepdim=True)
    start = _first_where(d0 == dmax, iota_m, M)
    sx = _at(xs, start, iota_m)
    sy = _at(ys, start, iota_m)
    skey = sx * COORD_BASE + sy

    at0 = iota_m == 0
    cost = torch.where(torch.arange(bw, device=dev).view(1, bw) == 0,
                       zero, big).expand(R, bw)
    curx, cury = sx.expand(R, bw), sy.expand(R, bw)
    vis = ((iota_m == start) | ~present).unsqueeze(1).expand(R, bw, M)
    pk = torch.where(at0, skey, torch.tensor(-1.0, dtype=F32, device=dev)
                     ).unsqueeze(1).expand(R, bw, M)
    px = torch.where(at0, sx, zero).unsqueeze(1).expand(R, bw, M)
    py = torch.where(at0, sy, zero).unsqueeze(1).expand(R, bw, M)
    xs3, ys3 = xs.unsqueeze(1), ys.unsqueeze(1)

    for step in range(M - 1):
        at_new = iota3 == step + 1
        # every beam's bw nearest untaken pins, first wins
        ddx = xs3 - curx.unsqueeze(2)
        ddy = ys3 - cury.unsqueeze(2)
        d = torch.where(vis, big, _root(ddx * ddx + ddy * ddy, real))
        taken = torch.zeros((R, bw, M), dtype=torch.bool, device=dev)
        c_cost, c_j = [], []
        for _c in range(bw):
            eff = torch.where(taken, inf2, d)
            m = eff.amin(dim=2, keepdim=True)
            j = _first_where(eff == m, iota3, M)
            taken = taken | (iota3 == j)
            ccost = cost.unsqueeze(2) + torch.where(m >= INF2, big, m)
            c_cost.append(torch.where(ccost >= BIG, big, ccost))
            c_j.append(j)
        # the candidates, parent-major: [R, bw (parent), bw (c), ...]
        j = torch.stack(c_j, 2)                               # [R,bw,bw,1]
        nx = _at(xs3.unsqueeze(1), j, iota3)
        ny = _at(ys3.unsqueeze(1), j, iota3)
        cand = {
            "cost": torch.stack(c_cost, 2).view(R, bw * bw),
            "pk": torch.where(at_new, nx * COORD_BASE + ny,
                              pk.unsqueeze(2)).reshape(R, bw * bw, M),
            "px": torch.where(at_new, nx, px.unsqueeze(2)
                              ).reshape(R, bw * bw, M),
            "py": torch.where(at_new, ny, py.unsqueeze(2)
                              ).reshape(R, bw * bw, M),
            "vis": (vis.unsqueeze(2) | (iota3 == j)).reshape(R, bw * bw, M),
            "cx": nx.view(R, bw * bw), "cy": ny.view(R, bw * bw)}
        # keep the bw best by (cost, path keys), first wins; positions past
        # step + 1 hold -1 in every candidate
        keys = [cand["cost"]] + [cand["pk"][:, :, t]
                                 for t in range(step + 2)]
        sel = _stable_order(keys)[:, :bw]
        active = (step + 1) <= (cnt - 1)

        def pick(name, old):
            v = cand[name]
            idx = sel if v.dim() == 2 else sel.unsqueeze(2).expand(R, bw, M)
            a = active if v.dim() == 2 else active.unsqueeze(2)
            return torch.where(a, torch.gather(v, 1, idx), old)
        cost, pk, px, py = (pick("cost", cost), pick("pk", pk),
                            pick("px", px), pick("py", py))
        vis, curx, cury = (pick("vis", vis), pick("cx", curx),
                           pick("cy", cury))

    # the final pick: the best beam by (cost, path keys), first wins
    best = _stable_order([cost] + [pk[:, :, t] for t in range(M)])[:, :1]
    idx = best.unsqueeze(2).expand(R, 1, M)
    return (torch.gather(px, 1, idx).view(R, M),
            torch.gather(py, 1, idx).view(R, M))


def beam_wl_int(params: Params, pax: torch.Tensor, pay: torch.Tensor,
                pnet: torch.Tensor, npin: torch.Tensor,
                real: torch.dtype = F32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-route wirelength and crossing count, ``([B,1] f32) * 2``
    (``reference.beam_wl_int``): every net routed by beam search from its
    outlier pin, ``cnt - 1`` segments a net; the wirelength added a term
    at a time, nets outer and positions inner; the crossings of every pair
    of routed segments on different nets."""
    B = pax.shape[0]
    N, M = params.max_num_nets, params.max_num_pins_per_net
    bw = int(params.reward_beam_width)
    dev = pax.device
    xs, ys, cnt = _net_tables(params, pax, pay, pnet, npin)
    bx, by = _beam_nets(xs.view(B * N, M), ys.view(B * N, M),
                        cnt.view(B * N, 1), bw, M, real)
    bx, by = bx.view(B, N, M), by.view(B, N, M)
    # segment t of net n: positions t -> t + 1, routed while t + 1 <= cnt - 1
    sv = (_iota(M - 1, dev).view(1, 1, M - 1) + 1) <= (cnt - 1)
    x1, y1, x2, y2 = bx[..., :-1], by[..., :-1], bx[..., 1:], by[..., 1:]
    dx = x1 - x2
    dy = y1 - y2
    zero = torch.zeros((), dtype=F32, device=dev)
    term = torch.where(sv, _root(dx * dx + dy * dy, real), zero)
    wl = torch.zeros((B, 1), dtype=F32, device=dev)
    for n in range(N):
        for t in range(M - 1):
            wl = (wl + term[:, n, t:t + 1]).to(real).to(F32)

    # pair (i, k) of segments, i's net below k's: i's segment first
    S = N * (M - 1)
    net = torch.arange(N, device=dev).repeat_interleave(M - 1)
    a = [v.reshape(B, S, 1) for v in (x1, y1, x2, y2)]
    b = [v.reshape(B, 1, S) for v in (x1, y1, x2, y2)]
    hit = _seg_intersect(*a, *b)
    v = sv.reshape(B, S)
    ok = (v.unsqueeze(2) & v.unsqueeze(1)
          & (net.view(1, S, 1) < net.view(1, 1, S)))
    ints = (hit & ok).to(F32).sum(dim=(1, 2)).view(B, 1)
    return wl, ints


#: the frozen reference's routed reward with the routes in wide operations
reward_rows = rebind(reference.reward_rows,
                    centroid_wl_int=reference_wide.centroid_wl_int,
                    beam_wl_int=beam_wl_int)
#: ``reference_wide``'s step and chunk, with that reward
_step = rebind(reference_wide._step, reward_rows=reward_rows)
rollout_chunk = rebind(reference_wide.rollout_chunk, _step=_step)
