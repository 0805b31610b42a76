"""The fused rollout chunk in plain PyTorch for boards of many components:
the yardstick that decides ``correct`` in the cells of the ``fused_wide``
engine.

``portbench/reference.py`` computes the same chunk, but it sorts with
bubble networks of elementwise operations (C(C - 1)/2 compare-and-swaps
for each net's allocation and for each component's cells) and tests the
routed segments' crossings a pin at a time. Each is a host call on the
card, so on 40 components and 100 pins a chunk takes it about a minute.
This copy computes the same function in fewer, wider operations:

  * the allocation's order by free space is a stable sort of its keys
    (which are unique), its bins, counts, water-fill and ranks' positions
    comparisons over whole [B, M, C] or [B, C] tables and prefix sums;
  * a component's cell order is a stable ascending sort of its cells'
    scores (ties in index order, as the network breaks them);
  * the centroid route's crossings are one test of every pair of pins,
    [B, P, P], each pair in the same integer frame and by the same f32
    operations as the pin-at-a-time test.

Everything else (the parameters, the counter hash, the legality planes,
the extra pins, the beam route, the penalty) is ``portbench/reference.py``'s
own code, imported from it. Like it, this file imports nothing of the
program, so a change to the program cannot move it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench import reference
from portbench.reference import (F32, I32, I64, LEAVES, Params, Variant,
                                 _M32, _extra_pins, _f32, _iota,
                                 _lane_gather, _mul32, _penalty,
                                 _planes_for, _Rng, _root, _seg_intersect)


def _allocate_net(params: Params, rng: _Rng, space, m, k0):
    """One net's pin -> component allocation (allocate_pins_to_components_
    for_net:1171): sort components by free space, capped multinomial over
    the k largest, then an in-order water-fill of the residue. Returns the
    component of each of the net's M pin ranks and the space left."""
    C, M = params.max_components, params.max_num_pins_per_net
    dev = space.device
    iota_c = _iota(C, dev)
    key = space * (C + 1) + (C - 1 - iota_c)
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    s_space = torch.gather(space, 1, order)
    s_idx = order.to(I32)
    not_enough = (torch.cumsum(s_space, 1) < m).sum(1, keepdim=True, dtype=I32)
    k = torch.maximum(k0, torch.clamp(not_enough + 1, max=C))
    w = torch.where(iota_c < k, s_space.to(F32),
                    torch.zeros((), dtype=F32, device=dev))
    tot_w = torch.maximum(w.sum(1, keepdim=True),
                          torch.tensor(1e-9, dtype=F32, device=dev))
    edges = torch.cumsum(w, 1)[:, :C - 1] / tot_w
    ut = rng.uniform(M)
    binm = (ut.unsqueeze(2) > edges.unsqueeze(1)).sum(2, dtype=I32)
    act = (_iota(M, dev) < m).unsqueeze(2)
    cnt = ((binm.unsqueeze(2) == iota_c.unsqueeze(1)) & act).sum(1,
                                                                 dtype=I32)
    cnt = torch.minimum(cnt, s_space)
    resid = m - cnt.sum(1, keepdim=True, dtype=I32)
    free = s_space - cnt
    before = torch.cumsum(free, 1, dtype=I32) - free
    cnt = cnt + torch.minimum(torch.clamp(resid - before, min=0), free)
    bounds = torch.cumsum(cnt, 1, dtype=I32)
    slot = (_iota(M, dev).unsqueeze(2) >= bounds.unsqueeze(1)).sum(
        2, dtype=I32)
    comp_of = _lane_gather(s_idx, torch.clamp(slot, max=C - 1))
    new_space = torch.zeros_like(space).scatter(1, s_idx.to(I64),
                                                s_space - cnt)
    return comp_of, new_space


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
        return fresh(comp_h, comp_w, numc, neg, neg, neg, neg, no_pins)
    area = comp_h * comp_w
    total_area = area.sum(1, keepdim=True, dtype=I32)

    nn = rng.randint(params.min_num_nets, params.max_num_nets, 1)
    nn = torch.clamp(torch.minimum(nn, total_area // 2), min=1)
    # call 6: the total pin count (drawn whatever it feeds, for the call
    # numbering)
    tp = torch.minimum(rng.randint(ppn * nn, max_ppn * nn, 1), total_area)
    net_open = _iota(N, dev) < nn
    net_counts = torch.where(net_open, ppn, 0).to(I32)
    if max_ppn > ppn:
        net_counts = net_counts + _extra_pins(
            params, rng, nn, net_open, torch.clamp(tp - ppn * nn, min=0))
    num_pins = net_counts.sum(1, keepdim=True, dtype=I32)
    ncum = torch.cumsum(net_counts, 1, dtype=I32)
    iota_p = _iota(P, dev)
    pin_net = (iota_p.unsqueeze(2) >= ncum.unsqueeze(1)).sum(2, dtype=I32)
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
    cell_table = torch.sort(scores.view(B, C, PPC), dim=2, stable=True
                            ).indices.to(I32).view(B, C * PPC)

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


def centroid_wl_int(params: Params, pax: torch.Tensor, pay: torch.Tensor,
                    pnet: torch.Tensor, npin: torch.Tensor,
                    real: torch.dtype = F32
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centroid-route wirelength and crossing count, ``([B,1] f32) * 2``
    (``reference.centroid_wl_int``): a 2-pin net routes pin0 -> pin1,
    otherwise every pin connects to the net centroid; the crossings of
    every pair of routed segments on different nets, each pair brought to
    the common integer frame s_p * s_q."""
    B, P = pax.shape
    N = params.max_num_nets
    dev = pax.device
    iota = torch.arange(P, dtype=I32, device=dev).expand(B, P)
    x = pax.to(F32)
    y = pay.to(F32)
    zero = torch.zeros((), dtype=F32, device=dev)
    in_use = iota < npin
    # per pin: its net's far end (raw and integer-scaled) and scale
    x2 = torch.zeros((B, P), dtype=F32, device=dev)
    y2 = torch.zeros_like(x2)
    x2s = torch.zeros_like(x2)
    y2s = torch.zeros_like(x2)
    s = torch.ones_like(x2)
    svalid = torch.zeros((B, P), dtype=torch.bool, device=dev)
    start = torch.zeros((B, 1), dtype=I32, device=dev)
    for n in range(N):
        mn = (pnet == n) & in_use
        c = mn.sum(dim=1, keepdim=True, dtype=I32)
        denom = torch.clamp(c, min=1).to(F32)
        sx = torch.where(mn, x, zero).sum(dim=1, keepdim=True)
        sy = torch.where(mn, y, zero).sum(dim=1, keepdim=True)
        rin = iota - start
        two = c == 2
        first = mn & (rin == 0)
        second = mn & (rin == 1)
        xs = torch.where(second, x, zero).sum(dim=1, keepdim=True)
        ys = torch.where(second, y, zero).sum(dim=1, keepdim=True)
        x2 = torch.where(mn, torch.where(two, xs, sx / denom), x2)
        y2 = torch.where(mn, torch.where(two, ys, sy / denom), y2)
        x2s = torch.where(mn, torch.where(two, xs, sx), x2s)
        y2s = torch.where(mn, torch.where(two, ys, sy), y2s)
        s = torch.where(mn, torch.where(
            two, torch.ones((), dtype=F32, device=dev), denom), s)
        svalid = svalid | (mn & ~(two & ~first))
        start = start + c
    dx = x - x2
    dy = y - y2
    wl = torch.where(svalid, _root(dx * dx + dy * dy, real),
                     zero).to(real).sum(dim=1, keepdim=True).to(F32)
    x1s = x * s
    y1s = y * s

    # pair (p, q), q > p: segment p scaled by s_q against segment q scaled
    # by s_p, as reference.centroid_wl_int's row p tests it
    def mine(t):
        return t.unsqueeze(2) * s.unsqueeze(1)

    def theirs(t):
        return t.unsqueeze(1) * s.unsqueeze(2)

    hit = _seg_intersect(mine(x1s), mine(y1s), mine(x2s), mine(y2s),
                         theirs(x1s), theirs(y1s), theirs(x2s), theirs(y2s))
    later = iota.unsqueeze(2) < iota.unsqueeze(1)
    ok = (svalid.unsqueeze(2) & svalid.unsqueeze(1) & later
          & (pnet.unsqueeze(2) != pnet.unsqueeze(1)))
    ints = (hit & ok).to(F32).sum(dim=(1, 2)).view(B, 1)
    return wl, ints


def reward_rows(params: Params, pax: torch.Tensor, pay: torch.Tensor,
                pnet: torch.Tensor, npin: torch.Tensor,
                real: torch.dtype = F32) -> torch.Tensor:
    """Routed terminal reward ``f32[B, 1]`` (``reference.reward_rows``):
    the centroid route here, the beam and "both" rewards the frozen
    reference's."""
    if params.reward_type != "centroid":
        return reference.reward_rows(params, pax, pay, pnet, npin, real)
    wl, ints = centroid_wl_int(params, pax, pay, pnet, npin, real)
    dev = wl.device
    lam_w, wl_norm, lam_i, int_norm = (
        _f32(v).to(dev, real) for v in (
            params.weight_wirelength, params.wirelength_normalizer,
            params.weight_num_intersections,
            params.intersections_normalizer))
    wl, ints = wl.to(real), ints.to(real)
    return (-(lam_w * (wl / wl_norm) + lam_i * (ints / int_norm))).to(F32)


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
    else:                              # PIN: planes 2, 3 copy 0, 1
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
        reward = alive.to(F32)
    if bool(done.any()):
        # route the post-placement tables, then swap in the fresh instances
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
    """The chunk in plain PyTorch, on the leaves' device
    (``reference.rollout_chunk``). Returns ``(leaves',
    reward_sum_per_board f32[B], done_count_per_board i32[B])``."""
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
