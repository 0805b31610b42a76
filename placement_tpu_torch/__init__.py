"""placement_tpu_torch — the PyTorch/CUDA port of ``placement_tpu``.

The JAX package ``placement_tpu`` stays the reference; this package mirrors
its layout and names so each counterpart is found by path
(``placement_tpu/ops/fused_rollout.py`` ->
``placement_tpu_torch/ops/fused_rollout.py``). It imports ``torch`` and
numpy, never ``jax`` or ``flax``.

What is ported so far (the throughput rollout of ``bench.py``):
  env/types.py          Variant, EnvParams (derived sizes, validate())
  utils/config.py       configs/*.json -> EnvParams
  ops/fused_routing.py  centroid routing reward on [B, P] pin tables
  ops/fused_rollout.py  the fused rollout chunk: plain PyTorch version and
                        the wrapper of the hand-written CUDA kernel
  ops/csrc/             the CUDA kernel, built by ops/_build.py
"""

__version__ = "0.1.0"

from placement_tpu_torch.env.types import EnvParams, Variant  # noqa: F401
