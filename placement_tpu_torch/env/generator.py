"""Batched instance generation (port of ``placement_tpu/env/generator.py``).

Draws ``B`` fresh instances at once from an explicit ``torch.Generator``:
components -> nets -> pins -> pin/net allocation -> pin/component
allocation -> pin cells, as the reference's ``generate_instances``
(dummy_env_rectangular_pin.py:1006-1035) and the JAX module do. The
``jax.random`` stream is not reproduced; the distributions are the same
(held by ``tests/test_torch_generator.py``).

Every JAX ``while_loop`` / ``scan`` runs a static number of rounds with the
finished boards masked, so nothing here waits for the device:
  * the exact per-trial sampler: ``max_trials`` rounds (JAX :90-91);
  * the exact pin -> component rounds: ``max_num_pins_per_net`` (JAX
    :257-258), since every draw lands on a component with space, so a round
    that has pins left assigns at least one;
  * the per-net allocation: ``max_num_nets`` rounds (JAX :293-296).
Categorical draws are Gumbel-max over the logits, which, unlike
``torch.multinomial``, accepts rows whose bins are all closed (an inactive
net's).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from placement_tpu_torch.env.types import EnvParams, Variant

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32


def _col(v: torch.Tensor) -> torch.Tensor:
    """A per-board value [B] as an int64 ``[B, 1]`` column."""
    return v.to(I64).reshape(-1, 1)


def _randint(gen: torch.Generator, lo, hi_inclusive, shape: Tuple[int, ...],
             device) -> torch.Tensor:
    """Uniform integers in ``[lo, hi_inclusive]``, i32 of ``shape = (B,
    ...)``; ``lo`` / ``hi_inclusive`` are host ints or per-board ``[B]``
    tensors (np.random.randint(lo, hi + 1) per board)."""
    u = torch.rand(shape, generator=gen, device=device)
    bshape = (-1,) + (1,) * (len(shape) - 1)

    def board(v):             # host ints stay on the host
        return v.to(I64).reshape(bshape) if isinstance(v, torch.Tensor) else v

    lo, hi = board(lo), board(hi_inclusive)
    draw = lo + torch.floor(u * (hi - lo + 1)).to(I64)
    return torch.clamp(draw, max=hi).to(I32)


def _categorical(gen: torch.Generator, logits: torch.Tensor,
                 num: int) -> torch.Tensor:
    """``num`` independent draws per row of ``logits`` [B, n] (``-inf`` =
    closed bin) by Gumbel-max -> int64 [B, num]. A row with every bin closed
    draws bin 0, as ``jax.random.categorical``'s argmax does."""
    b, n = logits.shape
    u = torch.rand((b, num, n), generator=gen, device=logits.device)
    tiny = torch.finfo(F32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits[:, None, :] + gumbel, dim=2)


def _log_probs(probs: torch.Tensor, open_bin: torch.Tensor) -> torch.Tensor:
    return torch.where(open_bin, torch.log(probs.clamp_min(1e-30)),
                       -float("inf"))


def _bincount(draws: torch.Tensor, n_bins: int,
              active: torch.Tensor) -> torch.Tensor:
    """counts[b, i] = #{t : draws[b, t] == i and active[b, t]}."""
    bins = torch.arange(n_bins, device=draws.device)
    onehot = (draws[:, :, None] == bins) & active[:, :, None]
    return onehot.sum(dim=1, dtype=I32)


def _waterfill(amount: torch.Tensor, capacity: torch.Tensor) -> torch.Tensor:
    """Greedy in-order fill of ``amount`` [B] into bins bounded by
    ``capacity`` [B, n], earlier bins first."""
    before = torch.cumsum(capacity, dim=1, dtype=I32) - capacity
    return torch.minimum((_col(amount) - before).clamp_min(0),
                         capacity.to(I64)).to(I32)


def _multinomial(gen: torch.Generator, n_trials: torch.Tensor,
                 probs: torch.Tensor, max_trials: int) -> torch.Tensor:
    """Multinomial of ``n_trials`` [B] draws by ``max_trials`` parallel
    categorical draws, the first ``n_trials`` of which count."""
    draws = _categorical(gen, _log_probs(probs, probs > 0), max_trials)
    active = (torch.arange(max_trials, device=probs.device)[None, :]
              < _col(n_trials))
    return _bincount(draws, probs.shape[1], active)


def _capped_multinomial_exact(gen: torch.Generator, n_trials: torch.Tensor,
                              probs: torch.Tensor, caps: torch.Tensor,
                              max_trials: int) -> torch.Tensor:
    """Per-trial renormalizing truncated multinomial, the exact process of
    the reference's ``sample_truncated_multinomial``
    (dummy_env_rectangular_pin.py:258-295): each of ``max_trials`` rounds
    draws one categorical over the bins below their cap; a round counts
    while trials remain and some bin is open."""
    b, n = probs.shape
    counts = torch.zeros((b, n), dtype=I32, device=probs.device)
    bins = torch.arange(n, device=probs.device)
    n_trials = n_trials.reshape(b)
    for _ in range(max_trials):
        open_bin = (counts < caps) & (probs > 0)
        draw = _categorical(gen, _log_probs(probs, open_bin), 1)
        left = (counts.sum(dim=1) < n_trials) & open_bin.any(dim=1)
        counts = counts + ((bins[None, :] == draw) & left[:, None]).to(I32)
    return counts


def _capped_multinomial(gen: torch.Generator, n_trials: torch.Tensor,
                        probs: torch.Tensor, caps: torch.Tensor,
                        max_trials: int) -> torch.Tensor:
    """Multinomial with a per-bin cap: three vectorized rounds (draw the
    remaining trials uncapped, clip at the caps) and a water-fill of any
    residue into open bins. Equal to the reference's sampler whenever no cap
    binds."""
    b, n = probs.shape
    counts = torch.zeros((b, n), dtype=I32, device=probs.device)
    steps = torch.arange(max_trials, device=probs.device)[None, :]
    n_trials = n_trials.reshape(b)
    for _ in range(3):
        remaining = n_trials - counts.sum(dim=1)
        free = caps - counts
        draws = _categorical(gen, _log_probs(probs, (free > 0) & (probs > 0)),
                             max_trials)
        add = _bincount(draws, n, steps < remaining[:, None])
        counts = counts + torch.minimum(add, free)
    residue = n_trials - counts.sum(dim=1)
    return counts + _waterfill(residue, caps - counts)


def generate_components(gen: torch.Generator, params: EnvParams, batch: int,
                        device) -> Tuple[torch.Tensor, ...]:
    """Component count [B] and sizes [B, C] (generate_components:983-1004);
    padding rows are 0."""
    c = params.max_components
    num = _randint(gen, params.min_num_components, params.max_num_components,
                   (batch,), device)
    comp_h = _randint(gen, params.min_component_h, params.max_component_h,
                      (batch, c), device)
    comp_w = _randint(gen, params.min_component_w, params.max_component_w,
                      (batch, c), device)
    valid = torch.arange(c, device=device)[None, :] < num[:, None]
    return (num, torch.where(valid, comp_h, 0).to(I32),
            torch.where(valid, comp_w, 0).to(I32))


def _allocate_pins_to_nets(gen: torch.Generator, params: EnvParams,
                           num_nets: torch.Tensor,
                           total_pins: torch.Tensor) -> torch.Tensor:
    """Pins of each net, i32[B, N] (allocate_pins_to_nets:1067): the minimum
    per open net, the rest by a capped multinomial over softmax(N(1/nets,
    1/(net_distribution + 1)))."""
    b = num_nets.shape[0]
    n_max = params.max_num_nets
    dev = num_nets.device
    net_open = torch.arange(n_max, device=dev)[None, :] < num_nets[:, None]
    min_ppn, max_ppn = (params.min_num_pins_per_net,
                        params.max_num_pins_per_net)
    base = torch.where(net_open, min_ppn, 0).to(I32)
    if max_ppn == min_ppn:
        return base
    extra_total = total_pins - min_ppn * num_nets
    samples = (1.0 / num_nets.clamp_min(1).to(F32)[:, None]
               + torch.randn((b, n_max), generator=gen, device=dev)
               / (params.net_distribution + 1.0))
    logits = torch.where(net_open, samples, -float("inf"))
    probs = torch.softmax(logits, dim=1)
    cap_each = torch.clamp(extra_total.clamp_min(0), max=max_ppn - min_ppn)
    caps = torch.where(net_open, cap_each[:, None], 0).to(I32)
    max_extra = (max_ppn - min_ppn) * n_max
    sampler = (_capped_multinomial_exact if params.exact_sampling
               else _capped_multinomial)
    return base + sampler(gen, extra_total.clamp_min(0), probs, caps,
                          max_extra)


def _searchsorted_right(bounds: torch.Tensor, width: int) -> torch.Tensor:
    """For ranks 0..width-1 per board: the number of ``bounds`` entries
    <= rank (jnp.searchsorted(bounds, ranks, side="right")), int64 [B, width]."""
    ranks = torch.arange(width, device=bounds.device)[None, :]
    return (bounds.to(I64)[:, None, :] <= ranks[:, :, None]).sum(dim=2)


def _exact_rounds(gen: torch.Generator, params: EnvParams, m: torch.Tensor,
                  sorted_space: torch.Tensor,
                  in_top: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One net's pins over its top components in the reference's redraw
    rounds (allocate_pins_to_components_for_net:1176-1264): each round draws
    a multinomial of the remaining pins proportional to the components'
    current free space, clips at capacity and assigns in component order.
    Returns (counts, slot of each rank, chunk-local id of each rank), all
    [B, ...] over the sorted components; a board with no pins left runs its
    round as a no-op."""
    b, c = sorted_space.shape
    m_max = params.max_num_pins_per_net
    dev = m.device
    ranks = torch.arange(m_max, device=dev)[None, :]
    remaining = m.to(I64)
    space = sorted_space
    comp_slot = torch.zeros((b, m_max + 1), dtype=I64, device=dev)
    local_of = torch.zeros((b, m_max + 1), dtype=I64, device=dev)
    ptr = torch.zeros((b, 1), dtype=I64, device=dev)
    for _ in range(m_max):
        w = torch.where(in_top, space.to(F32), 0.0)
        probs = w / w.sum(dim=1, keepdim=True).clamp_min(1e-30)
        draws = _categorical(gen, _log_probs(probs, probs > 0), m_max)
        cnt = torch.minimum(_bincount(draws, c, ranks < remaining[:, None]),
                            space)
        bounds = torch.cumsum(cnt, dim=1, dtype=I64)
        assigned = bounds[:, -1:]
        slot = _searchsorted_right(bounds, m_max).clamp(0, c - 1)
        in_round = ranks < assigned
        # rounds write distinct slots ptr + rank (< m_max); the rest go to
        # the spare slot m_max with its own value
        idx = torch.where(in_round, ptr + ranks, m_max)
        comp_slot = comp_slot.scatter(1, idx, torch.where(
            in_round, slot, comp_slot.gather(1, idx)))
        before = torch.where(slot > 0, bounds.gather(1, (slot - 1).clamp_min(0)),
                             0)
        local_of = local_of.scatter(1, idx, torch.where(
            in_round, ranks - before, local_of.gather(1, idx)))
        remaining = remaining - assigned[:, 0]
        space = space - cnt
        ptr = ptr + assigned
    return sorted_space - space, comp_slot[:, :m_max], local_of[:, :m_max]


def _fast_round(gen: torch.Generator, params: EnvParams, m: torch.Tensor,
                sorted_space: torch.Tensor,
                in_top: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One vectorized multinomial round proportional to free space with
    capacity caps (:1237-1253), then a water-fill of any capped-out
    remainder into open components in sorted order. Returns what
    ``_exact_rounds`` returns."""
    c = sorted_space.shape[1]
    m_max = params.max_num_pins_per_net
    w = torch.where(in_top, sorted_space.to(F32), 0.0)
    probs = w / w.sum(dim=1, keepdim=True).clamp_min(1e-30)
    counts = torch.minimum(_multinomial(gen, m, probs, m_max), sorted_space)
    counts = counts + _waterfill(m - counts.sum(dim=1), sorted_space - counts)
    bounds = torch.cumsum(counts, dim=1, dtype=I64)
    slot = _searchsorted_right(bounds, m_max).clamp(0, c - 1)
    before = torch.where(slot > 0, bounds.gather(1, (slot - 1).clamp_min(0)),
                         0)
    ranks = torch.arange(m_max, device=m.device)[None, :]
    return counts, slot, ranks - before


def _allocate_pins_to_components(gen: torch.Generator, params: EnvParams,
                                 num_components: torch.Tensor,
                                 comp_area: torch.Tensor,
                                 num_nets: torch.Tensor,
                                 net_counts: torch.Tensor
                                 ) -> Tuple[torch.Tensor, ...]:
    """Owning component of every pin slot (allocate_pins_to_components:1129
    / allocate_pins_to_components_for_net:1171): nets in order against a
    shared free-space budget; per net, components ranked by free space, the
    receiving set grown until its capacity covers the net, pins distributed
    in proportion to free space with capacity caps.

    Returns (pin_comp, pin_net, pin_chunk_local) i32[B, P] and num_pins
    i32[B]; pins are grouped by net as the reference rebuilds ``self.pins``
    (:1167-1169), and ``pin_chunk_local`` is the reference's per-(net,
    component, round) chunk-local ``pin_id`` (:1256-1258).
    """
    b, c = comp_area.shape
    p, n_max = params.max_pins, params.max_num_nets
    m_max = params.max_num_pins_per_net
    dev = comp_area.device

    ncum = torch.cumsum(net_counts, dim=1, dtype=I32)
    net_starts = ncum - net_counts
    num_pins = net_counts.sum(dim=1, dtype=I32)

    numc = num_components.to(I64)
    if params.variant == Variant.PIN_SPATIAL:
        k0 = (params.pin_spread * numc) // 10 + 1   # _spatial.py:1103
    else:
        k0 = (((params.pin_spread + 1) * numc) // 10).clamp_min(1)  # :1148-1151
    k0 = torch.minimum(k0, numc)[:, None]

    iota_c = torch.arange(c, device=dev)[None, :]
    valid_rank = torch.arange(m_max, device=dev)[None, :]
    space = comp_area.to(I32)
    comp_of, local_of = [], []
    for n in range(n_max):
        m = net_counts[:, n]
        active = (n < num_nets)[:, None]
        order = torch.argsort(-space, dim=1, stable=True)   # free space desc
        sorted_space = space.gather(1, order)
        enough = torch.cumsum(sorted_space, dim=1) >= m[:, None]
        first_enough = enough.to(I32).argmax(dim=1, keepdim=True) + 1
        k = torch.maximum(k0, torch.where(enough.any(dim=1, keepdim=True),
                                          first_enough, c))
        rounds = _exact_rounds if params.exact_sampling else _fast_round
        counts, slot, local = rounds(gen, params, m, sorted_space,
                                     iota_c < k)
        in_net = valid_rank < m[:, None]
        comp_of.append(torch.where(in_net & active, order.gather(1, slot), -1))
        local_of.append(torch.where(in_net, local, 0))
        # the consumed space, written back through the sort permutation
        new_space = torch.zeros_like(space).scatter(
            1, order, (sorted_space - counts).to(space.dtype))
        space = torch.where(active, new_space, space)
    comp_of = torch.cat(comp_of, dim=1)              # [B, N * M]
    local_of = torch.cat(local_of, dim=1)

    pin_slots = torch.arange(p, device=dev)[None, :]
    pin_net = (ncum.to(I64)[:, None, :] <= pin_slots[:, :, None]).sum(dim=2)
    pin_net = pin_net.clamp(0, n_max - 1)
    rank = pin_slots - net_starts.to(I64).gather(1, pin_net)
    in_use = ((pin_slots < num_pins[:, None]) & (pin_net < num_nets[:, None])
              & (rank < m_max))
    flat = pin_net * m_max + rank.clamp(0, m_max - 1)
    pin_comp = torch.where(in_use, comp_of.gather(1, flat), -1).to(I32)
    pin_local = torch.where(in_use, local_of.gather(1, flat), 0).to(I32)
    pin_net = torch.where(in_use, pin_net, -1).to(I32)
    return pin_comp, pin_net, pin_local, num_pins


def _place_pins_on_components(gen: torch.Generator, params: EnvParams,
                              comp_h: torch.Tensor, comp_w: torch.Tensor,
                              pin_comp: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distinct random cell (row-major) on the owning component for each pin
    (place_pins_on_component:1478-1498): a uniform random order of each
    component's cells, the component's pins taking successive cells in table
    order. Returns (rel_x, rel_y) i32[B, P], -1 for unused slots."""
    b, c = comp_h.shape
    ppc = params.max_num_pins_per_component
    dev = comp_h.device
    scores = torch.rand((b, c, ppc), generator=gen, device=dev)
    cell_valid = (torch.arange(ppc, device=dev)[None, None, :]
                  < (comp_h * comp_w)[:, :, None])
    scores = torch.where(cell_valid, scores, 2.0)
    cell_order = torch.argsort(scores, dim=2, stable=True).reshape(b, c * ppc)

    # rank of each pin within its component, in table order
    same = ((pin_comp[:, None, :] == pin_comp[:, :, None])
            & (pin_comp[:, :, None] >= 0))
    rank = torch.tril(same.to(I32), diagonal=-1).sum(dim=2)

    safe_comp = pin_comp.to(I64).clamp(0, c - 1)
    cell = cell_order.gather(1, safe_comp * ppc + rank.to(I64).clamp(0, ppc - 1))
    w = comp_w.to(I64).gather(1, safe_comp).clamp_min(1)
    used = pin_comp >= 0
    rel_x = torch.where(used, cell // w, -1).to(I32)
    rel_y = torch.where(used, cell % w, -1).to(I32)
    return rel_x, rel_y


def generate_instance(gen: torch.Generator, params: EnvParams, batch: int,
                      device) -> Dict[str, torch.Tensor]:
    """``batch`` full instance draws -> a dict of batched state fields
    (before the masks)."""
    c, p = params.max_components, params.max_pins
    num_components, comp_h, comp_w = generate_components(gen, params, batch,
                                                         device)
    comp_area = comp_h * comp_w
    total_area = comp_area.sum(dim=1, dtype=I32)
    neg_c = torch.full((batch, c), -1, dtype=I32, device=device)
    neg_p = torch.full((batch, p), -1, dtype=I32, device=device)
    inst = dict(num_components=num_components, comp_h=comp_h, comp_w=comp_w,
                comp_x=neg_c, comp_y=neg_c.clone(),
                pin_abs_x=neg_p, pin_abs_y=neg_p.clone())

    if not params.has_pins:
        zero = torch.zeros((batch,), dtype=I32, device=device)
        inst.update(pin_rel_x=neg_p.clone(), pin_rel_y=neg_p.clone(),
                    pin_net=neg_p.clone(), pin_comp=neg_p.clone(),
                    pin_local=torch.zeros_like(neg_p), num_nets=zero,
                    num_pins=zero.clone())
        return inst

    # sample_num_nets:1043, capped at the total component area / 2
    num_nets = _randint(gen, params.min_num_nets, params.max_num_nets,
                        (batch,), device)
    num_nets = torch.minimum(num_nets, total_area // 2).clamp_min(1)
    # sample_total_num_pins:1050, capped at the total component area
    total_pins = _randint(gen, params.min_num_pins_per_net * num_nets,
                          params.max_num_pins_per_net * num_nets,
                          (batch,), device)
    total_pins = torch.minimum(total_pins, total_area)

    net_counts = _allocate_pins_to_nets(gen, params, num_nets, total_pins)
    pin_comp, pin_net, pin_chunk_local, num_pins = (
        _allocate_pins_to_components(gen, params, num_components, comp_area,
                                     num_nets, net_counts))
    rel_x, rel_y = _place_pins_on_components(gen, params, comp_h, comp_w,
                                             pin_comp)

    if params.variant == Variant.PIN_SPATIAL:
        # the spatial env keeps the global creation index as pin_id:
        # generate_pins makes the base block (min_ppn per net, net-grouped)
        # first, then each net's extras in net order
        # (allocate_pins_to_nets:1096-1127), while the table holds each
        # net's base and extras together
        min_ppn = params.min_num_pins_per_net
        extras = (net_counts - min_ppn).clamp_min(0).to(I64)
        extras_before = torch.cumsum(extras, dim=1) - extras
        net_starts = (torch.cumsum(net_counts, dim=1, dtype=I64)
                      - net_counts.to(I64))
        slots = torch.arange(p, device=device)[None, :]
        safe_net = pin_net.to(I64).clamp(0, params.max_num_nets - 1)
        rank = slots - net_starts.gather(1, safe_net)
        creation = torch.where(
            rank < min_ppn, safe_net * min_ppn + rank,
            num_nets.to(I64)[:, None] * min_ppn
            + extras_before.gather(1, safe_net) + rank - min_ppn)
        pin_local = torch.where(pin_net >= 0, creation, 0).to(I32)
    else:
        pin_local = pin_chunk_local

    inst.update(pin_rel_x=rel_x, pin_rel_y=rel_y, pin_net=pin_net,
                pin_comp=pin_comp, pin_local=pin_local, num_nets=num_nets,
                num_pins=num_pins)
    return inst
