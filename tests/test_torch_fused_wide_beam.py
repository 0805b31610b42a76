"""The plain reference of the web_max.beam cell,
``portbench/reference_wide_beam.py``: the frozen reference's beam route in
wide operations.

  * its ``beam_wl_int`` equals the frozen ``reference.beam_wl_int`` bit for
    bit, in float32 and in the control's bfloat16, on seeded pin tables of
    web_max's shapes (10 nets of 2..10 pins on 30 x 30) and of the
    web_nets10_both row's (10 nets of 2..4 pins on 10 x 10), at widths 2
    and 4 and at the Train page's widest, 5 and 6 (the web_max.beam6
    cell's), their coordinates spread over the board or crowded onto 3 x 3
    cells (ties of distance and of path keys);
  * its chunk equals the frozen reference's under the beam and "both"
    rewards on web_max, at widths up to 6;
  * it imports nothing of the program;
  * the ``fused_wide_beam`` engine decides the web_max.beam cell's
    ``correct`` on a CPU run (the program's plain version in the kernel's
    place), and the control, the plain reference in bfloat16, reads not
    correct.
"""

import ast
import time

import pytest
import torch

from placement_tpu_torch.ops import fused_rollout
from placement_tpu_torch.utils.config import env_params_from_config
from portbench import manifest, reference, reference_wide_beam, run

BENCH = manifest.load()


def _params(config, **overrides):
    env = {**manifest.config(config)["env_config"], **overrides}
    return reference.Params.from_env_config(env)


def _pin_tables(params, boards, span, seed):
    """Seeded pin tables as the generator lays them out: a net's pins
    together in net order, 1..N nets open, each of min..max pins, the
    coordinates uniform on ``span`` x ``span`` cells."""
    gen = torch.Generator().manual_seed(seed)
    N, M, P = (params.max_num_nets, params.max_num_pins_per_net,
               params.max_pins)
    cnt = torch.randint(params.min_num_pins_per_net, M + 1, (boards, N),
                        generator=gen)
    nets = torch.randint(1, N + 1, (boards, 1), generator=gen)
    cnt = torch.where(torch.arange(N).view(1, N) < nets, cnt, 0)
    ncum = torch.cumsum(cnt, 1)
    slot = torch.arange(P).view(1, P)
    npin = ncum[:, -1:].to(torch.int32)
    pnet = (slot.unsqueeze(2) >= ncum.unsqueeze(1)).sum(2)
    pnet = torch.where(slot < npin, pnet, -1).to(torch.int32)
    pax, pay = (torch.randint(0, span, (boards, P), generator=gen,
                              dtype=torch.int32) for _ in range(2))
    return pax, pay, pnet, npin


@pytest.mark.parametrize("config,span", [("web_max", 30), ("web_max", 3),
                                         ("web_nets10", 10),
                                         ("web_nets10", 3)])
@pytest.mark.parametrize("bw", [2, 4, 5, 6])
def test_wide_beam_route_equals_the_frozen_one(config, span, bw):
    params = _params(config, reward_type="beam", reward_beam_width=bw)
    tables = _pin_tables(params, 24, span, 1000 * bw + span)
    for real in (torch.float32, torch.bfloat16):
        want = reference.beam_wl_int(params, *tables, real)
        got = reference_wide_beam.beam_wl_int(params, *tables, real)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(want[1].sum()) > 0         # crossings were counted


@pytest.mark.parametrize("reward,bw", [("beam", 4), ("both", 2),
                                       ("beam", 6), ("both", 5)])
def test_wide_beam_chunk_equals_the_frozen_one(reward, bw):
    """Two chained chunks of 4 web_max boards, logical block 4, from
    all-done zero boards: bit for bit, in float32 and in the control's
    bfloat16."""
    env = {**manifest.config("web_max")["env_config"],
           "reward_type": reward, "reward_beam_width": bw}
    params = reference.Params.from_env_config(env)
    leaves = fused_rollout.zero_leaves(env_params_from_config(env), 4,
                                       "cpu")
    for seed, real in ((5, torch.float32), (2**31 + 3, torch.bfloat16)):
        want = reference.rollout_chunk(params, leaves, seed, 50, 4, real)
        got = reference_wide_beam.rollout_chunk(params, leaves, seed, 50, 4,
                                                real)
        for name in reference.LEAVES:
            assert torch.equal(got[0][name], want[0][name]), name
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        leaves = want[0]
    assert int(got[2].sum()) >= 4


def test_wide_beam_reference_imports_nothing_of_the_program():
    tree = ast.parse((manifest.HERE / "reference_wide_beam.py").read_text())
    got = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            got |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            got.add(node.module.split(".")[0])
    assert got <= {"__future__", "types", "typing", "torch", "portbench"}, got


@pytest.mark.parametrize("control", [None, torch.bfloat16])
def test_wide_beam_engine_decides_correct_on_a_cpu_run(control):
    """The web_max.beam cell at 4 boards on the CPU (the program's plain
    version in the kernel's place): correct, and the control, the plain
    reference in bfloat16, not correct."""
    result = run.run_cell(BENCH, "web_max.beam", 2**31 + 9, 0.5, False,
                          "cpu", time.perf_counter(), boards=4,
                          warm_chunks=2, control=control)
    assert result["correct"] is (control is None)
    assert result["compared"]["leaf_mismatch"]["value"] == 0
