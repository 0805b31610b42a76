"""Legality masks via summed-area tables (port of
``placement_tpu/ops/sat.py``).

A 2-D prefix sum of the occupancy grid gives the occupied-cell count of any
``ph x pw`` rectangle in four gathers, so per-board component sizes are
integer offsets. Plain PyTorch on ``[B, H, W]`` grids with per-board sizes
``ph``, ``pw``, ``x``, ``y`` as ``[B]`` tensors: the JAX module is ``jnp``
lowered by XLA, not a kernel.
"""

from __future__ import annotations

import torch

I32 = torch.int32
I64 = torch.int64


def occupancy_sat(grid: torch.Tensor) -> torch.Tensor:
    """Zero-padded inclusive 2-D prefix sum: ``S[b, i, j] = sum(grid[b, :i,
    :j])``, i32[B, H+1, W+1]."""
    s = torch.cumsum(torch.cumsum(grid.to(I32), dim=1, dtype=I32), dim=2,
                     dtype=I32)
    return torch.nn.functional.pad(s, (1, 0, 1, 0))


def _col(v):
    """A per-board size as an int64 ``[B, 1]`` column; a host int stays a
    host int (no copy to the device) and broadcasts."""
    if isinstance(v, torch.Tensor):
        return v.to(I64).reshape(-1, 1)
    return v


def _free(sat: torch.Tensor, ph, pw, h: int, w: int) -> torch.Tensor:
    """bool[B, H, W]: a ``ph x pw`` rectangle anchored at (x, y) lies in the
    grid and covers no occupied cell."""
    b = sat.shape[0]
    dev = sat.device
    x = torch.arange(h, device=dev)[None, :]
    y = torch.arange(w, device=dev)[None, :]
    xe = x + _col(ph)                       # [B, H]
    ye = y + _col(pw)                       # [B, W]
    x2 = xe.clamp(0, h)
    y2 = ye.clamp(0, w)

    def rows(xi: torch.Tensor) -> torch.Tensor:  # sat[b, xi[b, i], :]
        return sat.gather(1, xi.expand(b, h)[:, :, None].expand(b, h, w + 1))

    def at(r: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
        return r.gather(2, yi.expand(b, w)[:, None, :].expand(b, h, w))

    top, bottom = rows(x), rows(x2)
    occ = at(bottom, y2) - at(top, y2) - at(bottom, y) + at(top, y)
    inb = (xe <= h)[:, :, None] & (ye <= w)[:, None, :]
    return inb & (occ == 0)


def free_placement_mask(grid: torch.Tensor, ph, pw) -> torch.Tensor:
    """mask[b, x, y] = 1 iff a ``ph[b] x pw[b]`` rectangle with top-left
    (x, y) is fully inside the grid and over unoccupied cells only."""
    _, h, w = grid.shape
    return _free(occupancy_sat(grid), ph, pw, h, w)


def orientation_action_mask(grid: torch.Tensor, comp_h, comp_w,
                            num_orientations: int) -> torch.Tensor:
    """All orientation planes of the legal-action mask, bool[B, O, H, W]:
    0 = (h, w), 1 = (w, h), planes 2/3 copies of 0/1
    (compute_action_mask, dummy_env_rectangular_pin.py:1853-1870)."""
    _, h, w = grid.shape
    sat = occupancy_sat(grid)
    p0 = _free(sat, comp_h, comp_w, h, w)
    if num_orientations == 1:
        return p0[:, None]
    p1 = _free(sat, comp_w, comp_h, h, w)
    if num_orientations == 2:
        return torch.stack([p0, p1], dim=1)
    return torch.stack([p0, p1, p0, p1], dim=1)


def paint_rectangle(grid: torch.Tensor, x, y, ph, pw,
                    value: int = 1) -> torch.Tensor:
    """``grid[b, x:x+ph, y:y+pw] = value`` with per-board ``[B]`` offsets
    (update_grid, dummy_env_rectangular_pin.py:1738-1765)."""
    _, h, w = grid.shape
    rows = torch.arange(h, device=grid.device)[None, :]
    cols = torch.arange(w, device=grid.device)[None, :]
    x, y = _col(x), _col(y)
    region = (((rows >= x) & (rows < x + _col(ph)))[:, :, None]
              & ((cols >= y) & (cols < y + _col(pw)))[:, None, :])
    return torch.where(region, value, grid)
