"""The synced batch norm (``models/blocks.py::sync_batch_norm``) on a model
whose grid encoder empties its map, at world 2 on gloo CPU ranks
(``mesh.spawn_ranks``): the ranks' counts sum to 0 for the empty block, so
its statistics are NaN, as Flax's are on the global batch; every other
statistic equals Flax's train-mode apply within 1e-5 and the outputs
within 1e-4 (the tolerances of ``test_torch_zoo_conv_edges.py``).

The JAX package is imported inside the test: the spawned ranks import this
module and need only the port.
"""

import dataclasses

import numpy as np
import torch

from placement_tpu_torch.models import convert
from placement_tpu_torch.models.blocks import sync_batch_norm
from placement_tpu_torch.models.zoo import ModelConfig, build_model
from placement_tpu_torch.parallel import mesh

WORLD = 2


def _sync_rank(rank, world, cfg_dict, variables, obs):
    """One gloo rank: the carried model, its batch norms synced over the
    ranks, one train-mode forward of this rank's block of ``obs``."""
    torch.set_num_threads(1)
    cfg = ModelConfig(**cfg_dict)
    model = build_model(cfg)
    model.load_state_dict(convert.state_dict_from_flax(variables, cfg),
                          strict=True)
    sync_batch_norm(model, torch.distributed.group.WORLD)
    n = obs["grid"].shape[0] // world
    block = {k: torch.as_tensor(v[rank * n:(rank + 1) * n])
             for k, v in obs.items()}
    model.train()
    with torch.no_grad():
        out = model(block)
    return ({k: v.numpy() for k, v in out.items()},
            {k: v for k, v in convert.to_flax(model.state_dict()).items()
             if k.startswith("batch_stats/")})


def test_sync_batch_norm_on_an_empty_map_at_world_two(monkeypatch):
    from tests.test_torch_zoo_conv_edges import (
        TRAIN_TOL, _empty_flagship, assert_same_stats, flax_eval_and_train)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    _, obs, jax_cfg, variables = _empty_flagship()
    _, train_out, stats = flax_eval_and_train(jax_cfg, variables, obs)
    want = {f"batch_stats/{k}": v for k, v in convert.flatten(stats).items()}
    assert np.isnan(want["batch_stats/grid_conv/BatchNorm_2/mean"]).all()
    ranks = mesh.spawn_ranks(
        _sync_rank, WORLD,
        args=(dataclasses.asdict(jax_cfg), variables, obs))
    n = obs["grid"].shape[0] // WORLD
    for r, (out, got) in enumerate(ranks):
        assert_same_stats(got, want, f"rank {r}")
        for k in train_out:
            np.testing.assert_allclose(
                out[k], np.asarray(train_out[k])[r * n:(r + 1) * n],
                rtol=TRAIN_TOL, atol=TRAIN_TOL, err_msg=f"rank {r}: {k}")
