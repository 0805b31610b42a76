"""The frozen work model is still ``chip_smoke.py``'s ``_chunk_bound``."""

import importlib.util

import pytest

from placement_tpu_torch.ops import fused_rollout
from placement_tpu_torch.utils.config import env_params_from_config
from portbench import manifest, reference, workmodel

BENCH = manifest.load()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_portbench", manifest.HERE.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_peaks_are_chip_smokes():
    cs = _chip_smoke()
    assert (workmodel.HBM_BYTES_S, workmodel.LANE_OPS_S,
            workmodel.INT_OPS_S) == (cs.HBM_BYTES_S, cs.LANE_OPS_S,
                                     cs.INT_OPS_S)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_chunk_bound_is_chip_smokes(cell):
    """On each cell's configuration and mix, from boards that a chunk has
    filled with pins, at 4,096 boards' count and a chunk's episodes."""
    cs = _chip_smoke()
    w = manifest.workload(BENCH, cell)
    traffic = manifest.traffic(w["traffic"])
    env = {**manifest.config(w["config"])["env_config"],
           **traffic["env_overrides"]}
    theirs = env_params_from_config(env)
    leaves, _, dcnt = fused_rollout.rollout_chunk_reference(
        theirs, fused_rollout.zero_leaves(theirs, 8, "cpu"), 4, 6, 8)
    episodes = 4096 * 10
    got = workmodel.chunk_bound(reference.Params.from_env_config(env), 4096,
                                50, episodes, leaves)
    want = cs._chunk_bound(theirs, 4096, 50, episodes, leaves)
    assert got == want
    assert got[1] == "operations" and got[0] > 0
