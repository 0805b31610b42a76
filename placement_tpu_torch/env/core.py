"""The batched placement stepper (port of ``placement_tpu/env/core.py``).

One ``reset`` / ``step`` pair covers all four reference environments
(``dummy_env_square.py:74/115``, ``dummy_env_rectangular.py:310/353``,
``dummy_env_rectangular_pin.py:1544/1599``,
``dummy_env_rectangular_pin_spatial.py``); the variants differ only in
orientation count, instance generation, reward and observation builders.

Every function takes the whole batch (``EnvState`` fields ``[B, ...]``),
where the JAX module is written per board and ``vmap``-ed. Control flow is
data-independent: per-board selects, loops of static length, and no value
read back to the host, so a step on the card is one stream of launches.
Randomness comes from an explicit ``torch.Generator`` on the state's
device. ``route_dtype`` is the float type of the routing reward
(``env/routing.py``): f32 in production, f64 for the reference's rounding.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import torch

from placement_tpu_torch.env import generator, routing
from placement_tpu_torch.env.types import EnvParams, EnvState, Variant
from placement_tpu_torch.ops.sat import orientation_action_mask, paint_rectangle

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32

Device = Union[str, torch.device]


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[b, idx[b]] for a [B, C] table and [B] indices in range."""
    return table.gather(1, idx.to(I64)[:, None])[:, 0]


# ---------------------------------------------------------------------------
# Reset
# ---------------------------------------------------------------------------

def reset(params: EnvParams, gen: torch.Generator, batch: int,
          device: Device) -> EnvState:
    """``batch`` fresh instances and their initial masks
    (DummyPlacementEnv.reset), drawn from ``gen`` on ``device``."""
    h, w = params.height, params.width
    grid = torch.zeros((batch, h, w), dtype=I32, device=device)
    zero = torch.zeros((batch,), dtype=I32, device=device)
    f_zero = torch.zeros((batch,), dtype=F32, device=device)
    done = torch.zeros((batch,), dtype=torch.bool, device=device)

    if params.variant == Variant.SQUARE:
        n = params.component_n
        neg_p = torch.full((batch, params.max_pins), -1, dtype=I32,
                           device=device)
        full_n = torch.full((batch, 1), n, dtype=I32, device=device)
        return EnvState(
            grid=grid, action_mask=orientation_action_mask(grid, n, n, 1),
            comp_h=full_n, comp_w=full_n.clone(),
            comp_x=torch.full_like(full_n, -1),
            comp_y=torch.full_like(full_n, -1),
            # unlimited supply of identical components: the episode only
            # ends when the mask empties (dummy_env_square.py:246-255)
            num_components=torch.full_like(zero, params.area), cursor=zero,
            pin_rel_x=neg_p, pin_rel_y=neg_p.clone(),
            pin_abs_x=neg_p.clone(), pin_abs_y=neg_p.clone(),
            pin_net=neg_p.clone(), pin_comp=neg_p.clone(),
            pin_local=torch.zeros_like(neg_p),
            pin_rel_x0=neg_p.clone(), pin_rel_y0=neg_p.clone(),
            num_nets=zero.clone(), num_pins=zero.clone(), done=done,
            steps=zero.clone(), info_wirelength=f_zero,
            info_intersections=f_zero.clone())

    inst = generator.generate_instance(gen, params, batch, device)
    mask = orientation_action_mask(grid, inst["comp_h"][:, 0],
                                   inst["comp_w"][:, 0],
                                   params.num_orientations)
    return EnvState(
        grid=grid, action_mask=mask, cursor=zero, done=done,
        pin_rel_x0=inst["pin_rel_x"].clone(),
        pin_rel_y0=inst["pin_rel_y"].clone(),
        steps=zero.clone(), info_wirelength=f_zero,
        info_intersections=f_zero.clone(), **inst)


# ---------------------------------------------------------------------------
# Pin rotation (Component.place_component, dummy_env_rectangular_pin.py:156-204)
# ---------------------------------------------------------------------------

def _rotate_pins(params: EnvParams, state: EnvState, orientation: torch.Tensor,
                 x: torch.Tensor, y: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """Relative pin coordinates of the current component turned to the
    chosen orientation, and their absolute positions: the explicit
    0/90/180/270-degree formulas. The reference mutates the relative
    coordinates in place, so they stay rotated for the rest of the
    episode."""
    cur = state.cursor
    mine = state.pin_comp == cur[:, None]
    safe = cur.clamp(0, params.max_components - 1)
    h = _take(state.comp_h, safe)[:, None]
    w = _take(state.comp_w, safe)[:, None]
    rx, ry = state.pin_rel_x, state.pin_rel_y
    o = orientation[:, None]
    new_rx = torch.where(o == 0, rx, torch.where(
        o == 1, ry, torch.where(o == 2, h - rx - 1, w - ry - 1)))
    new_ry = torch.where(o == 0, ry, torch.where(
        o == 1, h - rx - 1, torch.where(o == 2, w - ry - 1, rx)))
    rel_x = torch.where(mine, new_rx, rx)
    rel_y = torch.where(mine, new_ry, ry)
    abs_x = torch.where(mine, x[:, None] + rel_x, state.pin_abs_x)
    abs_y = torch.where(mine, y[:, None] + rel_y, state.pin_abs_y)
    return rel_x, rel_y, abs_x, abs_y


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------

def step(params: EnvParams, state: EnvState, action: torch.Tensor, *,
         defer_routing: bool = False, route_dtype: torch.dtype = F32
         ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, Dict]:
    """One transition of every board. ``action`` is int [B, 3] (orientation,
    x, y); the square variant ignores the orientation. Returns (state',
    reward f32[B], done bool[B], info). Reward/done/invalid semantics follow
    each reference env:

      square/rect invalid -> (same obs, 0.0, done=True)  (dummy_env_square.py:134,
          dummy_env_rectangular.py:424)
      pin invalid  -> episode ends with the worst-case penalty reward and
          wirelength/intersection info (dummy_env_rectangular_pin.py:1696-1710)

    ``defer_routing``: for pin variants, skip ``routing.terminal_reward``;
    reward and the info fields come back zero and
    ``info["placed_all_eff"]`` carries the flag the routing call needs, so
    a batched caller can route just the boards that finished (JAX
    ``core.py:126-134``). Non-pin variants ignore it.
    """
    h, w = params.height, params.width
    o_count = params.num_orientations
    c_max = params.max_components
    action = action.to(I64)
    orientation = action[:, 0].clamp(0, o_count - 1)
    x, y = action[:, 1], action[:, 2]

    in_bounds = ((action[:, 0] >= 0) & (action[:, 0] < o_count)
                 & (x >= 0) & (x < h) & (y >= 0) & (y < w))
    flat = (orientation * h + x.clamp(0, h - 1)) * w + y.clamp(0, w - 1)
    legal = state.action_mask.flatten(1).gather(1, flat[:, None])[:, 0]
    valid = in_bounds & legal & ~state.done

    cur = state.cursor.to(I64).clamp(0, c_max - 1)
    ch = _take(state.comp_h, cur)
    cw = _take(state.comp_w, cur)
    even = orientation % 2 == 0
    ph = torch.where(even, ch, cw)
    pw = torch.where(even, cw, ch)

    # --- apply placement (masked) -----------------------------------------
    v3 = valid[:, None, None]
    new_grid = torch.where(v3, paint_rectangle(state.grid, x, y, ph, pw),
                           state.grid)
    at_cur = torch.arange(c_max, device=cur.device)[None, :] == cur[:, None]
    put = at_cur & valid[:, None]
    comp_x = torch.where(put, x[:, None].to(I32), state.comp_x)
    comp_y = torch.where(put, y[:, None].to(I32), state.comp_y)

    if params.has_pins:
        rel_x, rel_y, abs_x, abs_y = _rotate_pins(params, state, orientation,
                                                  x, y)
        v2 = valid[:, None]
        rel_x = torch.where(v2, rel_x, state.pin_rel_x).to(I32)
        rel_y = torch.where(v2, rel_y, state.pin_rel_y).to(I32)
        abs_x = torch.where(v2, abs_x, state.pin_abs_x).to(I32)
        abs_y = torch.where(v2, abs_y, state.pin_abs_y).to(I32)
    else:
        rel_x, rel_y = state.pin_rel_x, state.pin_rel_y
        abs_x, abs_y = state.pin_abs_x, state.pin_abs_y

    cursor = state.cursor + valid.to(I32)
    placed_all = cursor >= state.num_components

    # --- next action mask -------------------------------------------------
    nxt = cursor.to(I64).clamp(0, c_max - 1)
    next_mask = orientation_action_mask(
        new_grid, _take(state.comp_h, nxt), _take(state.comp_w, nxt), o_count)
    next_mask = next_mask & ~placed_all[:, None, None, None]
    next_mask = torch.where(valid[:, None, None, None], next_mask,
                            state.action_mask)

    # --- done + reward ----------------------------------------------------
    mask_dead = ~next_mask.flatten(1).any(dim=1)
    done_valid = placed_all | mask_dead
    done = torch.where(valid, done_valid, True)

    zero = torch.zeros_like(state.info_wirelength)
    if not params.has_pins:
        reward = valid.to(F32)
        info_wl, info_int = state.info_wirelength, state.info_intersections
        info: Dict = {}
    elif defer_routing:
        # reward == terminal_reward(placed_all & valid) wherever done, else
        # 0; the caller recomputes it for done boards only
        reward, info_wl, info_int = zero, zero.clone(), zero.clone()
        info = {"placed_all_eff": placed_all & valid}
    else:
        term_reward, term_wl, term_int = routing.terminal_reward(
            params, abs_x, abs_y, state.pin_net, placed_all & valid,
            route_dtype)
        reward = torch.where(valid, torch.where(done_valid, term_reward, 0.0),
                             term_reward)
        info_wl = torch.where(done, term_wl, 0.0)
        info_int = torch.where(done, term_int, 0.0)
        info = {"wirelength": info_wl, "num_intersections": info_int}

    new_state = state.replace(
        grid=new_grid, action_mask=next_mask, comp_x=comp_x, comp_y=comp_y,
        cursor=cursor, pin_rel_x=rel_x, pin_rel_y=rel_y, pin_abs_x=abs_x,
        pin_abs_y=abs_y, done=done, steps=state.steps + 1,
        info_wirelength=info_wl, info_intersections=info_int)
    return new_state, reward, done, info


# ---------------------------------------------------------------------------
# Observations
# ---------------------------------------------------------------------------

def components_feature(params: EnvParams, state: EnvState) -> torch.Tensor:
    """all_components_feature f32[B, C, 5]: [h, w, x, y, area_ratio]
    (Component.calculate_feature, dummy_env_rectangular_pin.py:217-239).
    Unplaced components carry position (-1, -1); padding rows are zero."""
    area = (state.comp_h * state.comp_w).to(F32)
    area_ratio = area / torch.full_like(area, float(params.area))
    feat = torch.stack([
        state.comp_h.to(F32), state.comp_w.to(F32),
        state.comp_x.to(F32), state.comp_y.to(F32), area_ratio], dim=2)
    return torch.where(state.comp_valid[:, :, None], feat, 0.0)


def _last_writer(key: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """bool[B, P]: a valid pin no later valid pin (in table order) shares
    its ``key`` with — the pin whose write survives a scatter applied in
    table order."""
    p = key.shape[1]
    later = torch.triu(torch.ones((p, p), dtype=torch.bool,
                                  device=key.device), diagonal=1)
    clash = ((key[:, :, None] == key[:, None, :]) & valid[:, None, :]
             & later)                                    # [B, i, j > i]
    return valid & ~clash.any(dim=2)


def pins_feature(params: EnvParams, state: EnvState
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """all_pins_num_feature f32[B, C, ppc, 4] + all_pins_cat_feature
    f32[B, C, ppc, 1] for the PIN variant, written at (component_id,
    chunk-local pin_id) (update_all_pins_feature,
    dummy_env_rectangular_pin.py:1521-1542).

    The chunk-local id repeats when two nets' pins sit on one component
    (generator.py:178-183), so two pins can share a cell. The reference
    writes the pins in table order and the last one stays; a scatter with
    duplicate indices has no order on CUDA, so every pin a later pin
    overwrites is dropped first and the scatter writes distinct cells.
    """
    b = state.batch
    c, ppc = params.max_components, params.max_num_pins_per_component
    cells = (c + 1) * (ppc + 1)
    valid = state.pin_valid
    ci = torch.where(valid, state.pin_comp.to(I64), c)
    pi = torch.where(valid, state.pin_local.to(I64).clamp(0, ppc - 1), ppc)
    key = ci * (ppc + 1) + pi
    key = torch.where(_last_writer(key, valid), key, cells - 1)   # padding
    num = torch.zeros((b, cells, 4), dtype=F32, device=key.device)
    vals = torch.stack([state.pin_rel_x, state.pin_rel_y, state.pin_abs_x,
                        state.pin_abs_y], dim=2).to(F32)
    num = num.scatter(1, key[:, :, None].expand(-1, -1, 4), vals)
    cat = torch.zeros((b, cells), dtype=F32, device=key.device)
    cat = cat.scatter(1, key, state.pin_net.to(F32))
    num = num.view(b, c + 1, ppc + 1, 4)[:, :c, :ppc]
    cat = cat.view(b, c + 1, ppc + 1, 1)[:, :c, :ppc]
    return num, cat


def placement_mask(params: EnvParams, state: EnvState) -> torch.Tensor:
    """f32[B, C]. RECT: the binary placed flag
    (dummy_env_rectangular.py:275-284); pin envs: 0 absent, 1 to place, 2
    placed, 3 current (dummy_env_rectangular_pin.py:1577-1579, 1649-1657)."""
    if params.variant == Variant.RECT:
        return state.comp_placed.to(F32)
    c = torch.arange(params.max_components, device=state.device)[None, :]
    cur = state.cursor[:, None]
    codes = torch.where(c < cur, 2.0, torch.where(c == cur, 3.0, 1.0))
    return torch.where(state.comp_valid, codes, 0.0).to(F32)


def pin_grid_obs(params: EnvParams, state: EnvState) -> torch.Tensor:
    """pin_grid f32[B, H, W, max_num_nets + 1] (draw_pins,
    dummy_env_rectangular_pin_spatial.py:1663-1676): occupancy grid with pin
    cells overwritten by net_id + 2, one-hot over max_nets + 2 with the
    empty channel dropped. Placed pins have distinct cells; the others go
    to a padding cell."""
    b = state.batch
    h, w, n = params.height, params.width, params.max_num_nets
    placed = state.pin_valid & (state.pin_abs_x >= 0) & (state.pin_abs_y >= 0)
    xi = torch.where(placed, state.pin_abs_x.to(I64), h)
    yi = torch.where(placed, state.pin_abs_y.to(I64), w)
    vals = torch.nn.functional.pad(state.grid.to(I64), (0, 1, 0, 1))
    vals = vals.view(b, -1).scatter(
        1, xi * (w + 1) + yi,
        torch.where(placed, state.pin_net.to(I64) + 2, 0))
    vals = vals.view(b, h + 1, w + 1)[:, :h, :w]
    channels = torch.arange(1, n + 2, device=vals.device)
    return (vals[..., None] == channels).to(F32)


def component_grid_obs(params: EnvParams, state: EnvState,
                       orig_rel_x: torch.Tensor,
                       orig_rel_y: torch.Tensor) -> torch.Tensor:
    """component_grid f32[B, C, max_h, max_w, max_nets + 1] (draw_components,
    dummy_env_rectangular_pin_spatial.py:1677-1698): channel 0 is an
    all-ones stencil for every existing component; channels 1.. one-hot the
    reset-time (unrotated) pin positions by net. Rows past the instance's
    components are zero (the reference's leading dim is the component
    count, JAX ``core.py:296-300``)."""
    b = state.batch
    c = params.max_components
    mh, mw = params.max_component_h, params.max_component_w
    n = params.max_num_nets
    ok = state.pin_valid & (orig_rel_x >= 0)
    ci = torch.where(ok, state.pin_comp.to(I64), c)
    xi = torch.where(ok, orig_rel_x.to(I64).clamp(0, mh - 1), mh)
    yi = torch.where(ok, orig_rel_y.to(I64).clamp(0, mw - 1), mw)
    ni = torch.where(ok, (state.pin_net.to(I64) + 1).clamp(0, n), 0)
    idx = ((ci * (mh + 1) + xi) * (mw + 1) + yi) * (n + 1) + ni
    grid = torch.zeros((b, (c + 1) * (mh + 1) * (mw + 1) * (n + 1)),
                       dtype=F32, device=idx.device)
    grid = grid.scatter(1, idx, torch.ones_like(idx, dtype=F32))
    grid = grid.view(b, c + 1, mh + 1, mw + 1, n + 1)[:, :c, :mh, :mw]
    stencil = state.comp_valid.to(F32)[:, :, None, None].expand(b, c, mh, mw)
    return torch.cat([stencil[..., None], grid[..., 1:]], dim=4)


def _spatial_pins(params: EnvParams, state: EnvState
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PIN_SPATIAL's pin rows, indexed by the global pin id (one row per
    pin, a sentinel row last): num f32[B, rows, 4], cat i32[B, rows, 2]
    ([net, component], sentinel [-1, -1]), and each component's sorted pin
    ids f32[B, C, ppc] (-1 padded)."""
    b = state.batch
    c, ppc = params.max_components, params.max_num_pins_per_component
    rows = c * ppc + 1
    valid = state.pin_valid
    gi = torch.where(valid, state.pin_local.to(I64).clamp(0, rows - 2),
                     rows - 1)
    v = valid[:, :, None]
    num = torch.zeros((b, rows, 4), dtype=F32, device=gi.device)
    num = num.scatter(1, gi[:, :, None].expand(-1, -1, 4), torch.where(
        v, torch.stack([state.pin_rel_x, state.pin_rel_y, state.pin_abs_x,
                        state.pin_abs_y], dim=2).to(F32), 0.0))
    cat = torch.zeros((b, rows, 2), dtype=I32, device=gi.device)
    cat = cat.scatter(1, gi[:, :, None].expand(-1, -1, 2), torch.stack(
        [state.pin_net, state.pin_comp], dim=2))
    cat[:, rows - 1] = -1                 # the sentinel row stays [-1, -1]

    # rank of each pin within its component (table order == id order)
    same = ((state.pin_comp[:, None, :] == state.pin_comp[:, :, None])
            & valid[:, None, :] & valid[:, :, None])
    rank = torch.tril(same.to(I32), diagonal=-1).sum(dim=2)
    ci = torch.where(valid, state.pin_comp.to(I64), c)
    ri = torch.where(valid, rank.to(I64).clamp(0, ppc - 1), ppc)
    pin_ids = torch.full((b, (c + 1) * (ppc + 1)), -1, dtype=I32,
                         device=gi.device)
    pin_ids = pin_ids.scatter(1, ci * (ppc + 1) + ri,
                              torch.where(valid, state.pin_local, -1))
    pin_ids = pin_ids.view(b, c + 1, ppc + 1)[:, :c, :ppc].to(F32)
    return num, cat, pin_ids


def observe(params: EnvParams, state: EnvState) -> Dict[str, torch.Tensor]:
    """The reference observation dict of every board, for the variant."""
    grid = state.grid.to(F32)
    if params.variant == Variant.SQUARE:
        return {"grid": grid, "action_mask": state.action_mask[:, 0].to(F32)}

    obs = {
        "grid": grid,
        "action_mask": state.action_mask.to(F32),
        "all_components_feature": components_feature(params, state),
        "placement_mask": placement_mask(params, state),
    }
    if params.variant == Variant.RECT:
        obs["component_mask"] = state.comp_valid.to(F32)
        return obs
    if params.variant == Variant.PIN:
        num, cat = pins_feature(params, state)
        obs["all_pins_num_feature"] = num
        obs["all_pins_cat_feature"] = cat
        return obs

    # PIN_SPATIAL (dummy_env_rectangular_pin_spatial.py obs space :494-546):
    # the component feature extended with its sorted global pin ids
    num, cat, pin_ids = _spatial_pins(params, state)
    feat = torch.cat([obs["all_components_feature"], pin_ids], dim=2)
    obs["all_components_feature"] = torch.where(
        state.comp_valid[:, :, None], feat, 0.0)
    obs["all_pins_num_feature"] = num
    obs["all_pins_cat_feature"] = cat
    obs["pin_grid"] = pin_grid_obs(params, state)
    # frozen at reset in the reference (draw_components runs only in reset):
    # the reset-time, unrotated coordinates
    obs["component_grid"] = component_grid_obs(
        params, state, state.pin_rel_x0, state.pin_rel_y0)
    return obs


# ---------------------------------------------------------------------------
# Auto-reset batched stepping
# ---------------------------------------------------------------------------

def step_autoreset(params: EnvParams, state: EnvState, action: torch.Tensor,
                   gen: torch.Generator
                   ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, Dict]:
    """Step; boards that finish get a fresh instance (the returned state is
    the first of the new episode, gym's AutoReset convention). A fresh
    instance is drawn for every board and selected by ``done``, as the JAX
    function does (:385-397)."""
    stepped, reward, done, info = step(params, state, action)
    fresh = reset(params, gen, state.batch, state.device)
    return EnvState.where(done, fresh, stepped), reward, done, info


def check_device(device: Device, what: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises (the port's entry points never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device; pass device='cpu' to "
                           "run on the CPU")
    return device


def make_batched(params: EnvParams, device: Device = "cuda"
                 ) -> Tuple[Callable, Callable, Callable]:
    """Batched ``(reset_b, step_b, obs_b)`` closures on ``device``:
    ``reset_b(gen, batch) -> state``, ``step_b(state, action, gen) ->
    (state', reward, done, info)`` with auto-reset, ``obs_b(state) ->
    obs``. ``gen`` is a ``torch.Generator`` on ``device``. Raises without a
    card unless ``device`` is the CPU."""
    device = check_device(device, "make_batched")

    def reset_b(gen: torch.Generator, batch: int) -> EnvState:
        return reset(params, gen, batch, device)

    def step_b(state: EnvState, action: torch.Tensor, gen: torch.Generator
               ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, Dict]:
        return step_autoreset(params, state, action, gen)

    def obs_b(state: EnvState) -> Dict[str, torch.Tensor]:
        return observe(params, state)

    return reset_b, step_b, obs_b
