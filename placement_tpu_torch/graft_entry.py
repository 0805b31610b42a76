"""Entry points of the port (counterpart of ``__graft_entry__.py``).

    python -m placement_tpu_torch.graft_entry [n_ranks]

``entry()`` returns the flagship model's forward step (``rectangle_pin`` on
``configs/rectangle_pin_model.json``) and its example arguments
(:54-68). ``dryrun_multigpu(n)`` is the fused half of ``dryrun_multichip``
(:104-121): the fused rollout sharded over ``n`` ranks on that function's
reduced config, from boards fresh from the stepper's reset. The learner
half (``shard_learner`` and the full PPO train step) waits for the port of
the learner (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import math
import sys
from typing import Any, Callable, Dict, List, Tuple

import torch

from placement_tpu_torch.agent.policy import Policy
from placement_tpu_torch.env import core
from placement_tpu_torch.env.types import EnvParams
from placement_tpu_torch.parallel import mesh
from placement_tpu_torch.utils.config import load_env_params, load_experiment


def entry(device: str = "cuda") -> Tuple[Callable, Tuple[Any, ...]]:
    """-> (fn, example_args): ``fn(model, obs) -> (logits, value)``, the
    flagship model (eval mode, weights drawn from seed 1 with Flax's
    initializers) on the observations of 16 reset boards (generator seed
    0), on ``device``: the card unless the CPU is asked for (raises
    without a card)."""
    device = core.check_device(device, "entry")
    env_params, model_cfg, _ = load_experiment("rectangle_pin")
    policy = Policy(env_params, model_cfg, device, seed=1)
    states = core.reset(env_params, torch.Generator(device).manual_seed(0),
                        16, device)
    obs = core.observe(env_params, states)

    def fn(model: torch.nn.Module, obs: Dict[str, torch.Tensor]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            out = model(obs)
        return out["logits"], out["value"]

    return fn, (policy.model, obs)


#: ``dryrun_multichip``'s cut of the flagship config (:82-87): a 6x6 grid,
#: 2..3 components of 2..3 x 2..3, 2 nets of 2..3 pins (so the generator
#: runs the varying-pins allocation)
DRYRUN_OVERRIDES = dict(
    height=6, width=6, min_component_w=2, max_component_w=3,
    min_component_h=2, max_component_h=3,
    max_num_components=3, min_num_components=2,
    min_num_nets=2, max_num_nets=2,
    min_num_pins_per_net=2, max_num_pins_per_net=3)


def dryrun_params() -> EnvParams:
    """The flagship config with ``DRYRUN_OVERRIDES``."""
    return load_env_params("rectangle_pin").replace(
        **DRYRUN_OVERRIDES).validate()


def dryrun_multigpu(n_ranks: int, device: str = "cuda") -> List[Any]:
    """One 4-step chunk, seed 11, of ``4 * n_ranks`` boards fresh from the
    stepper's reset (``init_leaves``, as ``__graft_entry__.py:116-117``;
    each rank draws its 4 from a generator seeded 2 + rank), sharded over
    ``n_ranks`` spawned ranks on ``device``: by default the GPUs (ranks
    beyond the card count share cards); ``"cpu"`` runs the ranks on the
    CPU. Raises without a CUDA device unless the CPU is asked for, and
    unless the reduced reward is finite; returns the ranks' results
    (``mesh.reset_rollout_rank``)."""
    core.check_device(device, "dryrun_multigpu")
    results = mesh.spawn_ranks(
        mesh.reset_rollout_rank, n_ranks,
        args=(dryrun_params(), 4 * n_ranks, 4, 128, [11], 2, device),
        backend=mesh.backend_for(device, n_ranks))
    reward = results[0]["totals"][0][0]
    if not math.isfinite(reward):
        raise RuntimeError(f"sharded fused rollout reward {reward}")
    return results


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", [tuple(o.shape) for o in fn(*args)])
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    out = dryrun_multigpu(n)
    print(f"dryrun_multigpu({n}) ok: reward sum {out[0]['totals'][0][0]!r}, "
          f"episodes {out[0]['totals'][0][1]}")
