"""Test utilities: inject hand-built instances into an ``EnvState`` (port of
``placement_tpu/env/testing.py``).

The reference test-suites build fixtures by assigning ``env.components`` /
pin lists directly (tests/rectangular_environment/conftest.py:20-31,
tests/pin_environment/conftest.py:9-117). ``set_components`` does the same
against the batched state, so recorded reference instances replay through
the port without JAX.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from placement_tpu_torch.env.types import EnvParams, EnvState
from placement_tpu_torch.ops.sat import orientation_action_mask


class PinSpec:
    """Mirror of the reference Pin fixture fields
    (dummy_env_rectangular_pin.py:30-55)."""

    def __init__(self, relative_x: int, relative_y: int, pin_id: int,
                 component_id: int, net_id: int, absolute_x: int = -1,
                 absolute_y: int = -1):
        self.relative_x = relative_x
        self.relative_y = relative_y
        self.pin_id = pin_id
        self.component_id = component_id
        self.net_id = net_id
        self.absolute_x = absolute_x
        self.absolute_y = absolute_y


class ComponentSpec:
    """Mirror of the reference Component fixture fields."""

    def __init__(self, h: int, w: int, comp_id: int,
                 pins: Optional[List[PinSpec]] = None, position=(-1, -1)):
        self.h = h
        self.w = w
        self.comp_id = comp_id
        self.pins = pins or []
        self.position = position


def _refresh_action_mask(params: EnvParams, state: EnvState) -> EnvState:
    """The action mask of the component under each board's cursor on its
    grid (all-false once every component is placed)."""
    cur = state.cursor.to(torch.int64).clamp(0, params.max_components - 1)
    mask = orientation_action_mask(
        state.grid, state.comp_h.gather(1, cur[:, None])[:, 0],
        state.comp_w.gather(1, cur[:, None])[:, 0], params.num_orientations)
    alive = state.cursor < state.num_components
    return state.replace(action_mask=mask & alive[:, None, None, None])


def set_components(params: EnvParams, state: EnvState,
                   comps: Sequence[ComponentSpec]) -> EnvState:
    """Give every board of ``state`` the instance ``comps`` (cursor 0, grid
    untouched, action mask recomputed for component 0)."""
    c, p = params.max_components, params.max_pins
    comp = np.zeros((4, c), np.int32)
    comp[2:] = -1
    pin_rows = []
    for spec in comps:
        comp[:, spec.comp_id] = (spec.h, spec.w) + tuple(spec.position)
        pin_rows.extend(spec.pins)
    # net-grouped order like the reference's rebuilt self.pins (:1167-1169)
    pin_rows.sort(key=lambda q: q.net_id)
    pins = np.full((6, p), -1, np.int32)
    local = np.zeros(p, np.int32)
    for i, q in enumerate(pin_rows):
        pins[:, i] = (q.relative_x, q.relative_y, q.absolute_x, q.absolute_y,
                      q.net_id, q.component_id)
        local[i] = q.pin_id

    b, dev = state.batch, state.device

    def rows(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=dev).expand(b, -1).clone()

    def each(v: int) -> torch.Tensor:
        return torch.full((b,), v, dtype=torch.int32, device=dev)

    state = state.replace(
        comp_h=rows(comp[0]), comp_w=rows(comp[1]), comp_x=rows(comp[2]),
        comp_y=rows(comp[3]), num_components=each(len(comps)),
        cursor=each(0), pin_rel_x=rows(pins[0]), pin_rel_y=rows(pins[1]),
        pin_abs_x=rows(pins[2]), pin_abs_y=rows(pins[3]),
        pin_net=rows(pins[4]), pin_comp=rows(pins[5]), pin_local=rows(local),
        pin_rel_x0=rows(pins[0]), pin_rel_y0=rows(pins[1]),
        num_nets=each(len({q.net_id for q in pin_rows})),
        num_pins=each(len(pin_rows)),
        done=torch.zeros((b,), dtype=torch.bool, device=dev))
    return _refresh_action_mask(params, state)
