"""The frozen plain reference is still the program's plain version of the
chunk, on every cell's configuration and mix, and its parameters are the
program's."""

import dataclasses

import pytest
import torch

from placement_tpu_torch.ops import fused_rollout
from placement_tpu_torch.utils.config import env_params_from_config
from portbench import manifest, reference

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _env(cell):
    w = manifest.workload(BENCH, cell)
    traffic = manifest.traffic(w["traffic"])
    return ({**manifest.config(w["config"])["env_config"],
             **traffic["env_overrides"]}, traffic)


@pytest.mark.parametrize("cell", CELLS)
def test_params_are_the_programs(cell):
    env, _ = _env(cell)
    ours = reference.Params.from_env_config(env)
    theirs = env_params_from_config(env)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    for prop in ("area", "num_orientations", "max_components", "max_pins",
                 "max_num_pins_per_component", "has_pins", "max_wirelength",
                 "max_num_intersections", "intersections_normalizer",
                 "wirelength_normalizer"):
        assert getattr(ours, prop) == getattr(theirs, prop), prop
    assert reference.leaf_widths(ours) == fused_rollout.leaf_widths(theirs)
    assert reference.kernel_name(ours) == fused_rollout.kernel_name(theirs)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_the_programs_plain_chunk(cell):
    """Two chained chunks from all-done zero boards at 16 boards, logical
    block 8: every leaf, reward sum and done count equal bit for bit."""
    env, traffic = _env(cell)
    ours = reference.Params.from_env_config(env)
    theirs = env_params_from_config(env)
    leaves = fused_rollout.zero_leaves(theirs, 16, "cpu")
    for seed in (2**32 - 3, 91):
        want = fused_rollout.rollout_chunk_reference(
            theirs, leaves, seed, traffic["steps_per_chunk"], 8)
        got = reference.rollout_chunk(ours, leaves, seed,
                                      traffic["steps_per_chunk"], 8)
        for name in reference.LEAVES:
            assert torch.equal(got[0][name], want[0][name]), name
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        assert int(got[2].sum()) > 16
        leaves = want[0]
