"""The wide instantiation of the centroid kernel from the host: which
configurations run it, and the plain references the benchmark holds it to.

  * the tier pick: the benchmark's flagship and ``web_nets10`` cells keep
    the default and general instantiations; ``web_max`` (the web app's
    largest boards) runs the wide one;
  * ``portbench/reference.py``, the frozen copy of the plain version, still
    equals the port's plain version at a web_max-shaped size;
  * ``portbench/reference_wide.py``, which computes the chunk in fewer,
    wider operations, equals ``reference.py`` bit for bit on every cell's
    configuration, imports nothing of the program, and decides the new
    cell's ``correct`` on a CPU run as the frozen one decides the others'.
"""

import ast
import time

import pytest
import torch

from placement_tpu_torch.ops import fused_rollout
from placement_tpu_torch.utils.config import env_params_from_config
from portbench import manifest, reference, reference_wide, run

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
#: the instantiation each cell's configuration runs
TIERS = {"rectangle_pin.centroid": "default", "rectangle_pin.beam": "default",
         "web_nets10.centroid": "general", "web_nets10.both": "general",
         "web_max.centroid": "wide", "web_max.beam": "wide",
         "rectangle_pin.varpin": "default", "web_max.beam6": "wide6",
         "rectangle_pin.b16384": "default"}


def _env(cell):
    w = manifest.workload(BENCH, cell)
    traffic = manifest.traffic(w["traffic"])
    return ({**manifest.config(w["config"])["env_config"],
             **traffic["env_overrides"]}, traffic)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_its_tier(cell):
    env, _ = _env(cell)
    params = env_params_from_config(env)
    tier = fused_rollout.kernel_tier(params)
    assert tier == TIERS[cell]
    fn = fused_rollout.make_fused_rollout(params, 8, 5, device="cpu")
    assert fn.tier == tier
    assert fn._kparams.tier == fused_rollout.TIERS.index(tier)


def test_frozen_reference_equals_the_plain_version_at_web_max():
    """Two chained 45-step chunks of 8 all-done zero boards, logical block
    4: every leaf, reward sum and done count equal bit for bit."""
    env, _ = _env("web_max.centroid")
    ours = reference.Params.from_env_config(env)
    theirs = env_params_from_config(env)
    leaves = fused_rollout.zero_leaves(theirs, 8, "cpu")
    for seed in (2**32 - 5, 17):
        want = fused_rollout.rollout_chunk_reference(theirs, leaves, seed,
                                                     45, 4)
        got = reference.rollout_chunk(ours, leaves, seed, 45, 4)
        for name in reference.LEAVES:
            assert torch.equal(got[0][name], want[0][name]), name
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        leaves = want[0]
    assert int(got[2].sum()) >= 8


@pytest.mark.parametrize("cell", CELLS)
def test_wide_reference_equals_the_frozen_one(cell):
    """Two chained chunks of 8 boards, logical block 4, from all-done zero
    boards: bit for bit, in float32 and in the control's bfloat16."""
    env, traffic = _env(cell)
    params = reference.Params.from_env_config(env)
    leaves = fused_rollout.zero_leaves(env_params_from_config(env), 8,
                                       "cpu")
    steps = traffic["steps_per_chunk"]
    for seed, real in ((3, torch.float32), (2**31 + 11, torch.bfloat16)):
        want = reference.rollout_chunk(params, leaves, seed, steps, 4, real)
        got = reference_wide.rollout_chunk(params, leaves, seed, steps, 4,
                                           real)
        for name in reference.LEAVES:
            assert torch.equal(got[0][name], want[0][name]), name
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        leaves = want[0]


def test_wide_reference_imports_nothing_of_the_program():
    tree = ast.parse((manifest.HERE / "reference_wide.py").read_text())
    got = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            got |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            got.add(node.module.split(".")[0])
    assert got <= {"__future__", "typing", "torch", "portbench"}, got


@pytest.mark.parametrize("control", [None, torch.bfloat16])
def test_wide_engine_decides_correct_on_a_cpu_run(control):
    """The new cell at 8 boards on the CPU (the program's plain version in
    the kernel's place): correct, and the control, the plain reference in
    bfloat16, not correct."""
    result = run.run_cell(BENCH, "web_max.centroid", 2**31 + 7, 0.5, False,
                          "cpu", time.perf_counter(), boards=8,
                          warm_chunks=2, control=control)
    assert result["correct"] is (control is None)
    assert result["compared"]["leaf_mismatch"]["value"] == 0
