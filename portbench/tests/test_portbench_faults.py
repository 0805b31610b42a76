"""A whole run on the CPU, at a size a test run holds, with the timed path
broken underneath: each fault the cells can have, and the control (the
plain reference in bfloat16 in the program's place), makes ``correct``
false, and the sound path leaves it true. (The cells run on one chip:
there is no exchange between chips to leave out.)"""

import time

import pytest
import torch

from placement_tpu_torch.ops import fused_rollout
from portbench import manifest, reference, run

BENCH = manifest.load()
SOUND = fused_rollout.FusedRollout.per_board


def _unchanged(self, leaves, seed):
    """A chunk that returns its state unchanged."""
    zero = torch.zeros(self.batch)
    return dict(leaves), zero, zero.to(torch.int32)


def _half_batch(self, leaves, seed):
    """Half of the boards left out: the second half comes back as it went
    in, with no reward and no episode."""
    new, rsum, dcnt = SOUND(self, leaves, seed)
    h = self.batch // 2
    for name, t in new.items():
        t[h:] = leaves[name][h:]
    rsum[h:] = 0.0
    dcnt[h:] = 0
    return new, rsum, dcnt


def _reward_altered(self, leaves, seed):
    """One board's reward sum altered where it is produced."""
    new, rsum, dcnt = SOUND(self, leaves, seed)
    rsum[self.batch // 3] += 2.0 ** -9
    return new, rsum, dcnt


def _cell_altered(self, leaves, seed):
    """One board's grid cell flipped where it is produced."""
    new, rsum, dcnt = SOUND(self, leaves, seed)
    new["grid"][self.batch // 3, 0] = 1.0 - new["grid"][self.batch // 3, 0]
    return new, rsum, dcnt


def _control(cell):
    """The control: the plain reference in bfloat16 computes the chunk in
    the program's place."""
    w = manifest.workload(BENCH, cell)
    env = {**manifest.config(w["config"])["env_config"],
           **manifest.traffic(w["traffic"])["env_overrides"]}
    params = reference.Params.from_env_config(env)

    def per_board(self, leaves, seed):
        return reference.rollout_chunk(params, leaves, seed, self.num_steps,
                                       self.block, torch.bfloat16)
    return per_board


FAULTS = {"unchanged": lambda cell: _unchanged,
          "half_batch": lambda cell: _half_batch,
          "reward_altered": lambda cell: _reward_altered,
          "cell_altered": lambda cell: _cell_altered,
          "bf16_control": _control}


def _run(cell):
    return run.run_cell(BENCH, cell, 2**31 + 11, 0.3, False, "cpu",
                        time.perf_counter(), boards=16, warm_chunks=1)


@pytest.mark.parametrize("cell", ["rectangle_pin.centroid",
                                  "rectangle_pin.beam", "web_nets10.both"])
@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_makes_the_run_not_correct(monkeypatch, cell, fault):
    monkeypatch.setattr(fused_rollout.FusedRollout, "per_board",
                        FAULTS[fault](cell))
    result = _run(cell)
    assert result["correct"] is False
    assert result["failed"] >= 1
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("cell", ["rectangle_pin.centroid",
                                  "web_nets10.centroid"])
def test_the_sound_path_is_correct(cell):
    result = _run(cell)
    assert result["correct"] is True and result["failed"] == 0
    assert result["compared"]["chunks_short"]["value"] == 0
    assert set(result["metrics"]) == {"env_steps_per_s", "setup_s"}
