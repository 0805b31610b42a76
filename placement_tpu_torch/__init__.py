"""placement_tpu_torch — the PyTorch/CUDA port of ``placement_tpu``.

The JAX package ``placement_tpu`` stays the reference; this package mirrors
its layout and names so each counterpart is found by path
(``placement_tpu/ops/fused_rollout.py`` ->
``placement_tpu_torch/ops/fused_rollout.py``). It imports ``torch`` and
numpy, never ``jax`` or ``flax``.

What is ported so far:
  env/types.py          Variant, EnvParams, the batched EnvState
  env/core.py, generator.py, routing.py, wrappers.py, testing.py
                        the batched stepper (reset, step, observe)
  env/pooled.py         the pooled auto-reset engine (rollout_chunk)
  env/gym_api.py        the single-board gym-0.22 adapter
  models/               the ten-preset model zoo, the action
                        distributions, Flax weights -> state_dict
  agent/policy.py       Policy.act and Policy.evaluate
  agent/random_policy.py the random-policy baseline
  viz/rollout.py        greedy rollout sampling and its records
  utils/config.py       configs/*.json -> (EnvParams, ModelConfig)
  ops/sat.py            occupancy tables and legality masks
  ops/fused_routing.py  centroid, beam and "both" routing rewards on
                        [B, P] pin tables
  ops/fused_rollout.py  the fused rollout chunk: plain PyTorch version and
                        the wrapper of the hand-written CUDA kernels
  ops/csrc/             the CUDA kernels, built by ops/_build.py
  agent/ppo.py, agent/trainer.py  PPO and the Trainer (checkpoints,
                        metrics, profiling, the sampling-fidelity check)
  env/compat.py, env/fidelity.py  the reference-process generator and the
                        sampling-fidelity check (NumPy)
  experiments/ppo.py    the training CLI (data-parallel, multi-process)
  parallel/mesh.py      the learner and the fused rollout over ranks
  tools/bench_matrix.py the per-configuration throughput matrix
  tools/train_throughput.py  a PPO iteration's env-steps/s over ranks
  graft_entry.py        the flagship forward step and the sharded dry run
"""

__version__ = "0.1.0"

from placement_tpu_torch.env.types import EnvParams, Variant  # noqa: F401
