"""The control, the plain reference in bfloat16 put in the program's place,
fails each cell's limits at a size a test run holds, where the program's
plain version passes them. (On the card the control is read at the cells'
own size by ``python -m portbench.calibrate``.)"""

import pytest
import torch

from placement_tpu_torch.ops import fused_rollout
from placement_tpu_torch.utils.config import env_params_from_config
from portbench import manifest, reference

BENCH = manifest.load()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_where_the_program_passes(cell):
    w = manifest.workload(BENCH, cell)
    traffic = manifest.traffic(w["traffic"])
    env = {**manifest.config(w["config"])["env_config"],
           **traffic["env_overrides"]}
    ours = reference.Params.from_env_config(env)
    limits = manifest.cell(cell)["limits"]
    leaves = fused_rollout.zero_leaves(env_params_from_config(env), 24,
                                       "cpu")
    steps = traffic["steps_per_chunk"]
    want = reference.rollout_chunk(ours, leaves, 77, steps, 8)
    control = reference.rollout_chunk(ours, leaves, 77, steps, 8,
                                      torch.bfloat16)
    program = fused_rollout.rollout_chunk_reference(
        env_params_from_config(env), leaves, 77, steps, 8)
    gap = float((control[1].double() - want[1].double()).abs().max())
    assert gap > limits["reward_gap"]
    assert float((program[1].double() - want[1].double()).abs().max()) \
        <= limits["reward_gap"]
