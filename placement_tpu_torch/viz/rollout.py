"""Greedy rollout sampling and its records (the sampling half of
``placement_tpu/viz/rollout.py``).

The reference's ``sample_rollout`` restores a PPO checkpoint, plays
``num_samples=5`` greedy episodes and records each episode's component list
and action sequence (``utils/agent/utils.py:188-259``). Here the episodes
play side by side as one batch of boards through ``core.step``, and the
padded tensors are decoded into the host-side records
(:class:`ComponentRecord` / :class:`PinRecord`) that the renderer and the
web app read. ``save_to_file`` / ``load_pickle`` / ``save_config_to_csv``
are the JAX module's file helpers, copied. Exporting a trained run's
rollouts (``generate_rollouts``) comes with the trainer.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import pickle
from typing import Any, Dict, List, Optional, Tuple

import torch

from placement_tpu_torch.env import core
from placement_tpu_torch.env.types import EnvParams, EnvState


@dataclasses.dataclass
class PinRecord:
    """Host-side mirror of the reference ``Pin``
    (dummy_env_rectangular_pin.py:13-55)."""

    relative_x: int
    relative_y: int
    pin_id: int
    component_id: int
    net_id: int
    absolute_x: int = -1
    absolute_y: int = -1


@dataclasses.dataclass
class ComponentRecord:
    """Host-side mirror of the reference ``Component``
    (dummy_env_rectangular_pin.py:122-155)."""

    h: int
    w: int
    comp_id: int
    pins: List[PinRecord] = dataclasses.field(default_factory=list)
    position: Tuple[int, int] = (-1, -1)
    orientation: int = 0


def components_from_state(params: EnvParams, state: EnvState,
                          board: int = 0) -> List[ComponentRecord]:
    """Board ``board``'s padded component/pin tables as reset-time records
    (unrotated relative pin positions, as the reference stores them after
    ``generate_instances``)."""
    get = lambda x: x[board].tolist()   # noqa: E731
    n = int(state.num_components[board])
    comp_h, comp_w = get(state.comp_h), get(state.comp_w)
    pin_net, pin_comp = get(state.pin_net), get(state.pin_comp)
    pin_local = get(state.pin_local)
    rel_x0, rel_y0 = get(state.pin_rel_x0), get(state.pin_rel_y0)
    comps = [ComponentRecord(h=comp_h[i], w=comp_w[i], comp_id=i)
             for i in range(n)]
    for p, c in enumerate(pin_comp):
        if pin_net[p] >= 0 and 0 <= c < n:
            comps[c].pins.append(PinRecord(
                relative_x=rel_x0[p], relative_y=rel_y0[p],
                pin_id=pin_local[p], component_id=c, net_id=pin_net[p]))
    return comps


def play_episodes(params: EnvParams, policy, states: EnvState,
                  gen: torch.Generator, explore: bool = False,
                  max_steps: Optional[int] = None
                  ) -> Tuple[List[List[ComponentRecord]],
                             List[List[Tuple[int, int, int]]],
                             List[Dict[str, float]]]:
    """One episode from each board of ``states`` (fresh boards), played by
    ``policy`` (greedy unless ``explore``) for at most ``max_steps``
    (default: one per component, plus one). Returns per board (components,
    actions (orientation, x, y), terminal info with the reward)."""
    b = states.batch
    comps = [components_from_state(params, states, i) for i in range(b)]
    actions: List[List[Tuple[int, int, int]]] = [[] for _ in range(b)]
    infos: List[Dict[str, float]] = [{} for _ in range(b)]
    live = [True] * b
    for _ in range(max_steps or params.max_components + 1):
        action, _, _, _ = policy.act(core.observe(params, states), gen,
                                     deterministic=not explore)
        states, reward, done, info = core.step(params, states, action)
        a, d = action.tolist(), done.tolist()
        r = reward.tolist()
        info = {k: v.tolist() for k, v in info.items()}
        for i in range(b):
            if not live[i]:
                continue
            actions[i].append(tuple(a[i]))
            if d[i]:
                infos[i] = {k: v[i] for k, v in info.items()}
                infos[i]["reward"] = r[i]
                live[i] = False
        if not any(live):
            break
    return comps, actions, infos


def sample_rollout(params: EnvParams, policy, num_samples: int = 5,
                   seed: int = 0, explore: bool = False,
                   max_steps: Optional[int] = None,
                   device: core.Device = "cuda"):
    """Play ``num_samples`` episodes on ``device`` (the card unless the CPU
    is asked for; the policy's device), greedy when ``explore=False``, as
    ``compute_single_action(..., explore=False)``
    (utils/agent/utils.py:243). Returns per episode (components, actions,
    terminal info)."""
    device = core.check_device(device, "sample_rollout")
    if policy.device.type != device.type:
        raise ValueError(f"policy on {policy.device}, rollout on {device}")
    gen = torch.Generator(device).manual_seed(seed)
    states = core.reset(params, gen, num_samples, device)
    return play_episodes(params, policy, states, gen, explore, max_steps)


def save_to_file(dir_path: str, components, actions) -> None:
    """Pickle components/actions for replay
    (utils/visualization/csv_utils.py:11-25)."""
    os.makedirs(dir_path, exist_ok=True)
    with open(os.path.join(dir_path, "components.pkl"), "wb") as f:
        pickle.dump(components, f)
    with open(os.path.join(dir_path, "actions.pkl"), "wb") as f:
        pickle.dump(actions, f)


def load_pickle(dir_path: str) -> Tuple[Optional[dict], Any, Any]:
    """(params, actions, components) of a run directory that this module
    wrote; a missing file gives None (web_app/visualization_grid.py:13-69).
    Unpickles: only for files this program wrote."""
    def _load(name):
        path = os.path.join(dir_path, name)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return pickle.load(f)

    params = None
    params_path = os.path.join(dir_path, "params.json")
    if os.path.exists(params_path):
        with open(params_path) as f:
            params = json.load(f)
    return params, _load("actions.pkl"), _load("components.pkl")


def save_config_to_csv(path: str, env_config: Dict[str, Any],
                       model_config: Dict[str, Any]) -> None:
    """Flatten env+model config into a 1-row CSV
    (utils/visualization/csv_utils.py:28-77)."""
    row = {f"env/{k}": v for k, v in sorted(env_config.items())}
    row.update({f"model/{k}": v for k, v in sorted(model_config.items())})
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row))
        w.writeheader()
        w.writerow(row)
