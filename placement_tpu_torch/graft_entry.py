"""Entry points of the port (counterpart of ``__graft_entry__.py``).

    python -m placement_tpu_torch.graft_entry [n_ranks]

``entry()`` returns the flagship model's forward step (``rectangle_pin`` on
``configs/rectangle_pin_model.json``) and its example arguments
(:54-68). ``dryrun_multigpu(n)`` is ``dryrun_multichip`` (:71-121) over
``n`` spawned ranks, on that function's reduced config: its learner half,
the full PPO train step (rollout, GAE, minibatched update) through
``parallel.mesh.shard_learner``, then its fused half, the fused rollout
sharded over the ranks from boards fresh from the stepper's reset.
"""

from __future__ import annotations

import math
import sys
from typing import Any, Callable, Dict, List, Tuple

import torch

from placement_tpu_torch.agent.policy import Policy, model_config_for
from placement_tpu_torch.agent.ppo import PPOConfig, PPOLearner
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


def learner_rank(rank: int, world: int, device: str = "cuda"
                 ) -> Dict[str, float]:
    """The learner half of the dry run on one rank (a ``spawn_ranks``
    worker; ``__graft_entry__.py:71-102``): the flagship model family on
    ``dryrun_params()``, ``PPOConfig(num_envs=2 * world, unroll_length=2,
    minibatch_size=2 * world, num_sgd_iter=2)``, one sharded
    ``train_step`` from a generator seeded 0. Returns its metrics."""
    dev = mesh.rank_device(rank, device)
    params = dryrun_params()
    policy = Policy(params, model_config_for(params, "rectangle_pin"), dev)
    learner = PPOLearner(params, policy, PPOConfig(
        num_envs=2 * world, unroll_length=2, minibatch_size=2 * world,
        num_sgd_iter=2))
    place, train_step = mesh.shard_learner(learner, mesh.make_mesh(world,
                                                                   dev))
    state = place(learner.init(torch.Generator(dev).manual_seed(0)))
    _, metrics = train_step(state)
    return {k: float(v) for k, v in metrics.items()}


def dryrun_rank(rank: int, world: int, device: str = "cuda"
                ) -> Dict[str, Any]:
    """Both halves of the dry run on one rank: ``learner_rank``, then
    ``mesh.reset_rollout_rank`` (4 boards a rank fresh from the reset,
    generator seeded 2 + rank, one 4-step chunk at seed 11). Returns the
    latter's result with the learner's ``metrics``."""
    metrics = learner_rank(rank, world, device)
    out = mesh.reset_rollout_rank(rank, world, dryrun_params(), 4 * world,
                                  4, 128, [11], 2, device)
    return {**out, "metrics": metrics}


def dryrun_multigpu(n_ranks: int, device: str = "cuda") -> List[Any]:
    """``dryrun_rank`` over ``n_ranks`` spawned ranks on ``device``: by
    default the GPUs (NCCL with a card a rank; ranks beyond the card count
    share cards over gloo); ``"cpu"`` runs gloo ranks on the CPU. Raises
    without a CUDA device unless the CPU is asked for, unless every
    learner metric is finite and unless the fused half's reduced reward
    is; returns the ranks' results."""
    core.check_device(device, "dryrun_multigpu")
    results = mesh.spawn_ranks(dryrun_rank, n_ranks, args=(device,),
                               backend=mesh.backend_for(device, n_ranks))
    bad = sorted(k for res in results for k, v in res["metrics"].items()
                 if not math.isfinite(v))
    if bad:
        raise RuntimeError(f"sharded train step: metrics not finite: {bad}")
    reward = results[0]["totals"][0][0]
    if not math.isfinite(reward):
        raise RuntimeError(f"sharded fused rollout reward {reward}")
    return results


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", [tuple(o.shape) for o in fn(*args)])
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    out = dryrun_multigpu(n)
    print(f"dryrun_multigpu({n}) ok: train step {out[0]['metrics']!r}; "
          f"reward sum {out[0]['totals'][0][0]!r}, episodes "
          f"{out[0]['totals'][0][1]}")
