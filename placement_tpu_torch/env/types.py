"""Environment parameter and state containers (port of
``placement_tpu/env/types.py``).

``Variant`` and the frozen ``EnvParams`` are copied field for field, with
every derived property and ``validate()``, so a config loads to the same
values in both packages. ``EnvState`` holds the JAX pytree's fields as
tensors with a leading batch dimension: the JAX functions are written per
board and ``vmap``-ed, the port's take the whole batch.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Dict, Union

import numpy as np
import torch


class Variant(enum.IntEnum):
    """Which of the four reference environments to emulate."""

    SQUARE = 0        # dummy_env_square.py
    RECT = 1          # dummy_env_rectangular.py
    PIN = 2           # dummy_env_rectangular_pin.py
    PIN_SPATIAL = 3   # dummy_env_rectangular_pin_spatial.py


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Static environment configuration (hashable).

    Field names mirror the reference constructor signatures
    (``dummy_env_rectangular_pin.py:396-416``) so the ``configs/*.json``
    schema loads directly.
    """

    variant: Variant = Variant.PIN
    height: int = 10
    width: int = 10

    # Square variant only (dummy_env_square.py:37).
    component_n: int = 2

    # Component geometry (rect + pin variants).
    min_component_w: int = 2
    max_component_w: int = 2
    min_component_h: int = 2
    max_component_h: int = 2
    min_num_components: int = 5
    max_num_components: int = 5

    # Nets / pins (pin variants), cf. dummy_env_rectangular_pin.py:400-411.
    net_distribution: int = 9
    pin_spread: int = 9
    min_num_nets: int = 3
    max_num_nets: int = 3
    min_num_pins_per_net: int = 2
    max_num_pins_per_net: int = 6

    # Sampling fidelity of the batched stepper's generator (see the JAX
    # package); the fused rollout does not read it.
    exact_sampling: bool = False

    # Reward (pin variants), cf. dummy_env_rectangular_pin.py:412-416.
    reward_type: str = "both"  # "beam" | "centroid" | "both"
    reward_beam_width: int = 2
    weight_wirelength: float = 0.5
    weight_num_intersections: float = 0.5

    # ---- derived static sizes -------------------------------------------------

    @property
    def area(self) -> int:
        return self.height * self.width

    @property
    def num_orientations(self) -> int:
        return {Variant.SQUARE: 1, Variant.RECT: 2,
                Variant.PIN: 4, Variant.PIN_SPATIAL: 4}[self.variant]

    @property
    def max_components(self) -> int:
        """Padded component-table length (1 for the square variant)."""
        if self.variant == Variant.SQUARE:
            return 1
        return self.max_num_components

    @property
    def max_num_pins_per_component(self) -> int:
        # dummy_env_rectangular_pin.py:481
        return self.max_component_h * self.max_component_w

    @property
    def max_pins(self) -> int:
        """Padded global pin-table length."""
        if self.variant in (Variant.SQUARE, Variant.RECT):
            return 1
        return self.max_num_nets * self.max_num_pins_per_net

    @property
    def max_segments_per_net(self) -> int:
        """Worst-case routed segments for one net (centroid: one per pin)."""
        return self.max_num_pins_per_net

    @property
    def has_pins(self) -> bool:
        return self.variant in (Variant.PIN, Variant.PIN_SPATIAL)

    # Upper-bound penalty terms, cf. dummy_env_rectangular_pin.py:761-830.
    @property
    def max_wirelength(self) -> float:
        dist = math.hypot(float(self.height), float(self.width))
        total = 0.5 * dist * (self.max_num_nets * self.max_num_pins_per_net)
        if self.variant == Variant.PIN_SPATIAL:
            # Spatial env pre-normalizes by (h + w), dummy_env_rectangular_pin_spatial.py:746.
            return total / (self.height + self.width)
        return total

    @property
    def max_num_intersections(self) -> float:
        v = (0.5 * self.max_num_pins_per_net ** 2
             * self.max_num_nets * (self.max_num_nets - 1))
        if self.variant == Variant.PIN_SPATIAL:
            return v  # spatial env keeps the float, dummy_env_rectangular_pin_spatial.py:785
        return float(int(v))  # pin env truncates to int, dummy_env_rectangular_pin.py:822

    @property
    def intersections_normalizer(self) -> float:
        """min(avg pins by component area, avg pins by nets); find_reward:882-896."""
        avg_by_comp = (0.5 * (self.min_component_h + self.max_component_h)
                       * 0.5 * (self.min_component_w + self.max_component_w)
                       * 0.5 * (self.min_num_components + self.max_num_components))
        avg_by_net = (0.5 * (self.min_num_pins_per_net + self.max_num_pins_per_net)
                      * 0.5 * (self.min_num_nets + self.max_num_nets))
        return min(avg_by_comp, avg_by_net)

    @property
    def wirelength_normalizer(self) -> float:
        return float(self.height + self.width)

    def validate(self) -> "EnvParams":
        """Mirror of the reference's constructor validation
        (dummy_env_rectangular_pin.py:565-641, dummy_env_rectangular.py:239-251,
        dummy_env_square.py:67-72). Returns self for chaining."""
        if self.height <= 0 or self.width <= 0:
            raise ValueError("Grid size must be greater than 0.")
        if self.variant == Variant.SQUARE:
            if self.component_n > self.height or self.component_n > self.width:
                raise ValueError(
                    "Component size must be less than or equal to the grid size.")
            return self
        if (self.max_component_w > self.width
                or self.max_component_h > self.height):
            raise ValueError(
                "Component size must be less than or equal to the grid size.")
        if self.min_component_w < 1 or self.min_component_h < 1:
            raise ValueError("Component size must be greater than 0.")
        if self.max_num_components < 1 or self.max_num_components > self.area:
            raise ValueError(
                "Number of components must be greater than 0 and less than or "
                "equal to the grid area.")
        if not self.has_pins:
            return self
        if self.min_num_pins_per_net > self.max_num_pins_per_net:
            raise ValueError(
                "min_num_pins_per_net must not be greater than max num pins per net")
        if self.min_num_pins_per_net < 2:
            raise ValueError("min num pins per net must be at least 2.")
        if (self.min_num_pins_per_net * self.min_num_nets
                > self.min_component_w * self.min_component_h
                * self.min_num_components):
            raise ValueError(
                "min_num_pins_per_net * min_num_nets must be less than or equal "
                "to the total minimum area covered by the components")
        if self.reward_beam_width < 1:
            raise ValueError("Beam width must be a positive integer.")
        if self.reward_type not in ("beam", "centroid", "both"):
            raise ValueError(
                "Reward type must be either 'beam', 'centroid', or 'both'.")
        return self

    def replace(self, **kw: Any) -> "EnvParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class EnvState:
    """A batch of boards' full state (the JAX ``EnvState``, :197-254).

    Every field has a leading batch dimension ``B`` (H, W = grid; O =
    orientations; C = max_components; P = max_pins). There is no ``key``:
    randomness comes from an explicit ``torch.Generator`` passed to
    ``core.reset`` / ``core.step_autoreset``. Integer fields are int32 as in
    JAX; indices are cast to int64 where they index.
    """

    # Board occupancy; 1 = occupied.
    grid: torch.Tensor            # i32[B, H, W]
    # Legal-action planes per orientation.
    action_mask: torch.Tensor     # bool[B, O, H, W]

    # Component table.
    comp_h: torch.Tensor          # i32[B, C] original height (never rotated)
    comp_w: torch.Tensor          # i32[B, C]
    comp_x: torch.Tensor          # i32[B, C] top-left row, -1 when unplaced
    comp_y: torch.Tensor          # i32[B, C]
    num_components: torch.Tensor  # i32[B]
    cursor: torch.Tensor          # i32[B] current component (== num_components when all placed)

    # Pin table (pin variants only; length-1 dummies otherwise).
    pin_rel_x: torch.Tensor       # i32[B, P] rotation-updated relative row
    pin_rel_y: torch.Tensor       # i32[B, P]
    pin_abs_x: torch.Tensor       # i32[B, P] absolute row; -1 until placed
    pin_abs_y: torch.Tensor       # i32[B, P]
    pin_net: torch.Tensor         # i32[B, P] net id, -1 for padding
    pin_comp: torch.Tensor        # i32[B, P] owning component, -1 for padding
    pin_local: torch.Tensor       # i32[B, P] id within component (PIN) or global id (PIN_SPATIAL)
    pin_rel_x0: torch.Tensor      # i32[B, P] reset-time relative row
    pin_rel_y0: torch.Tensor      # i32[B, P]
    num_nets: torch.Tensor        # i32[B]
    num_pins: torch.Tensor        # i32[B]

    # Episode bookkeeping.
    done: torch.Tensor            # bool[B]
    steps: torch.Tensor           # i32[B]

    # Terminal-reward components surfaced in `info`.
    info_wirelength: torch.Tensor     # f32[B]
    info_intersections: torch.Tensor  # f32[B]

    @property
    def batch(self) -> int:
        return self.done.shape[0]

    @property
    def device(self) -> torch.device:
        return self.grid.device

    @property
    def comp_valid(self) -> torch.Tensor:
        c = self.comp_h.shape[1]
        return (torch.arange(c, device=self.device)[None, :]
                < self.num_components[:, None])

    @property
    def comp_placed(self) -> torch.Tensor:
        c = self.comp_h.shape[1]
        return (torch.arange(c, device=self.device)[None, :]
                < self.cursor[:, None])

    @property
    def pin_valid(self) -> torch.Tensor:
        return self.pin_net >= 0

    def replace(self, **kw: Any) -> "EnvState":
        return dataclasses.replace(self, **kw)

    def to(self, device: Union[str, torch.device]) -> "EnvState":
        return EnvState(**{f: getattr(self, f).to(device)
                           for f in STATE_FIELDS})

    @staticmethod
    def where(mask: torch.Tensor, a: "EnvState", b: "EnvState") -> "EnvState":
        """Per board: ``a``'s fields where ``mask`` (bool[B]), else ``b``'s
        (the auto-reset select, JAX ``core.py:393-396``)."""
        def sel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
            return torch.where(mask.view((-1,) + (1,) * (x.dim() - 1)), x, y)
        return EnvState(**{f: sel(getattr(a, f), getattr(b, f))
                           for f in STATE_FIELDS})


#: EnvState's fields, in declaration order
STATE_FIELDS = tuple(f.name for f in dataclasses.fields(EnvState))
_BOOL_FIELDS = ("action_mask", "done")
_FLOAT_FIELDS = ("info_wirelength", "info_intersections")


def _field_dtype(name: str) -> torch.dtype:
    if name in _BOOL_FIELDS:
        return torch.bool
    return torch.float32 if name in _FLOAT_FIELDS else torch.int32


def state_from_numpy(arrays: Dict[str, np.ndarray],
                     device: Union[str, torch.device]) -> EnvState:
    """A batched state as numpy arrays keyed by field name (e.g. a JAX
    ``EnvState``'s fields; a ``key`` entry is ignored) -> the port's
    ``EnvState`` on ``device``: bool masks, f32 info, int32 the rest."""
    return EnvState(**{f: torch.as_tensor(np.array(arrays[f]))
                       .to(device=device, dtype=_field_dtype(f))
                       for f in STATE_FIELDS})


def state_to_numpy(state: EnvState) -> Dict[str, np.ndarray]:
    """The inverse of ``state_from_numpy``."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in STATE_FIELDS}
