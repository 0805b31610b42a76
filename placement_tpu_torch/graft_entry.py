"""Entry points of the port (counterpart of ``__graft_entry__.py``).

    python -m placement_tpu_torch.graft_entry [n_ranks]

``dryrun_multigpu(n)`` is the fused half of ``dryrun_multichip`` (:104-121):
the fused rollout sharded over ``n`` ranks on that function's reduced
config. The learner half (``shard_learner`` and the full PPO train step)
waits for the port of the models and the learner (ROADMAP.md queue 1 items
7-8); ``entry`` (a model's forward step) for the models.
"""

from __future__ import annotations

import math
import sys
from typing import Any, List

import torch

from placement_tpu_torch.env.types import EnvParams
from placement_tpu_torch.parallel import mesh
from placement_tpu_torch.utils.config import load_env_params


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
    """One 4-step chunk of ``4 * n_ranks`` all-done zero boards, seed 11,
    sharded over ``n_ranks`` spawned ranks on ``device``: by default the
    GPUs (ranks beyond the card count share cards); ``"cpu"`` runs the
    ranks on the CPU. Raises without a CUDA device unless the CPU is asked
    for, and unless the reduced reward is finite; returns the ranks'
    results (``mesh.rollout_rank``)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multigpu: no CUDA device; pass "
                           "device='cpu' to run the ranks on the CPU")
    results = mesh.spawn_ranks(
        mesh.rollout_rank, n_ranks,
        args=(dryrun_params(), 4 * n_ranks, 4, 128, [11], device),
        backend=mesh.backend_for(device, n_ranks))
    reward = results[0]["totals"][0][0]
    if not math.isfinite(reward):
        raise RuntimeError(f"sharded fused rollout reward {reward}")
    return results


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    out = dryrun_multigpu(n)
    print(f"dryrun_multigpu({n}) ok: reward sum {out[0]['totals'][0][0]!r}, "
          f"episodes {out[0]['totals'][0][1]}")
