"""Environment parameter container (port of ``placement_tpu/env/types.py``).

``Variant`` and the frozen ``EnvParams`` are copied field for field, with
every derived property and ``validate()``, so a config loads to the same
values in both packages. The JAX file also defines the ``EnvState`` pytree;
it needs ``flax`` and waits for the port of the batched stepper.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any


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
