"""Host-side gym-style adapter over the batched stepper (port of
``placement_tpu/env/gym_api.py``).

The reference exposes OpenAI-Gym 0.22 environments (``reset()`` returning
the observation only, ``step()`` a 4-tuple; ``environment/dummy_env_*.py``).
``PlacementEnv`` gives that imperative interface for one board, backed by
``core.reset`` / ``step`` / ``observe`` at batch 1 on a device (the card
unless the CPU is asked for), with the flattening wrappers
(``utils/environment/env_wrappers.py:9-199``) as a constructor flag.
Observations come back as numpy arrays, rewards and infos as Python
scalars. Batch training uses ``env/core.py`` or ``env/pooled.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from placement_tpu_torch.env import core
from placement_tpu_torch.env.types import EnvParams, EnvState, Variant
from placement_tpu_torch.env.wrappers import (
    decode_flat_action, flat_action_size, flatten_mask)


class PlacementEnv:
    """Single-board, stateful ``reset()/step()`` interface.

    ``flatten_actions=True`` accepts a flat integer action and flattens the
    observation's ``action_mask``: the reference's
    ``FlatteningActionWrapper*`` + ``FlatteningActionMaskObservationWrapper*``
    (utils/agent/utils.py:394-418)."""

    def __init__(self, params: EnvParams, seed: int = 0,
                 flatten_actions: bool = False,
                 device: core.Device = "cuda"):
        self.params = params.validate()
        self.flatten_actions = flatten_actions
        self.device = core.check_device(device, "PlacementEnv")
        self.gen = torch.Generator(self.device).manual_seed(seed)
        self.state: "EnvState | None" = None

    # -- spaces (plain sizes; no gym dependency) ---------------------------

    @property
    def action_size(self) -> int:
        return flat_action_size(self.params)

    @property
    def action_shape(self) -> Tuple[int, ...]:
        """(O, H, W) bounds of the tuple action (or (H, W) for square)."""
        p = self.params
        if p.variant == Variant.SQUARE:
            return (p.height, p.width)
        return (p.num_orientations, p.height, p.width)

    # -- gym 0.22 API ------------------------------------------------------

    def seed(self, seed: int) -> None:
        self.gen.manual_seed(seed)

    def reset(self) -> Dict[str, np.ndarray]:
        self.state = core.reset(self.params, self.gen, 1, self.device)
        return self._obs()

    def step(self, action: Union[int, Tuple[int, ...], np.ndarray]
             ) -> Tuple[Dict[str, np.ndarray], float, bool, Dict[str, Any]]:
        if self.state is None:
            raise RuntimeError("call reset() before step()")
        self.state, reward, done, info = core.step(
            self.params, self.state, self._coerce_action(action)[None])
        info_np = {k: float(v[0]) for k, v in info.items()}
        return self._obs(), float(reward[0]), bool(done[0]), info_np

    # -- reference convenience accessors -----------------------------------

    @property
    def grid(self) -> np.ndarray:
        return self.state.grid[0].cpu().numpy()

    @property
    def action_mask(self) -> np.ndarray:
        """bool mask in the reference layout: [O, H, W] (square: [H, W])."""
        m = self.state.action_mask[0].cpu().numpy()
        return m[0] if self.params.variant == Variant.SQUARE else m

    def validate_action(self, action) -> bool:
        """Legality test (DummyPlacementEnv.validate_action,
        dummy_env_rectangular_pin.py:1712-1736) by the current mask."""
        o, x, y = self._coerce_action(action).tolist()
        m = self.state.action_mask[0]
        return bool(m[o, x, y]) if all(
            0 <= v < n for v, n in zip((o, x, y), m.shape)) else False

    # -- internals ---------------------------------------------------------

    def _coerce_action(self, action) -> torch.Tensor:
        """A flat id, (x, y) for square, or (o, x, y) -> i32[3]."""
        if self.flatten_actions or (np.isscalar(action)
                                    and not isinstance(action, tuple)):
            return decode_flat_action(
                self.params, torch.tensor(int(action), device=self.device))
        a = np.asarray(action, np.int32)
        if a.shape == (2,):                  # square tuple action (x, y)
            a = np.concatenate([[0], a]).astype(np.int32)
        if a.shape != (3,):
            raise ValueError(f"action must be flat int, (x, y), or "
                             f"(o, x, y); got shape {a.shape}")
        return torch.as_tensor(a, device=self.device)

    def _obs(self) -> Dict[str, np.ndarray]:
        obs = {k: v[0].cpu().numpy()
               for k, v in core.observe(self.params, self.state).items()}
        if self.flatten_actions:
            obs["action_mask"] = flatten_mask(
                self.params, self.state.action_mask[0]).cpu().numpy() \
                .astype(obs["action_mask"].dtype)
        return obs


def make(env_type: str = "rectangle_pin", seed: int = 0,
         flatten_actions: bool = False, device: core.Device = "cuda",
         **env_overrides) -> PlacementEnv:
    """Build from a model type's config JSON with keyword overrides
    (``init_env``/``create_env``, utils/agent/utils.py:317-418)."""
    from placement_tpu_torch.utils.config import load_env_params
    params = load_env_params(env_type)
    if env_overrides:
        params = params.replace(**env_overrides).validate()
    return PlacementEnv(params, seed=seed, flatten_actions=flatten_actions,
                        device=device)
