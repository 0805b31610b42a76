"""The port's sampling-fidelity guard (``placement_tpu_torch/env/
{compat,fidelity}.py``, the port's own NumPy copies against its own
``EnvParams``) against the JAX package's, which are deterministic NumPy:
the same reference-process instances after the same seeds, the same
``deviation_report`` ``(tvd, noise, deviates)`` and the same
``check_sampling_fidelity`` warning and return value; and the port's
``Trainer`` running the check where the JAX trainer does
(``placement_tpu/agent/trainer.py:71-84``).
"""

import dataclasses
import os
import random
import warnings

import numpy as np
import pytest
import torch

from placement_tpu.env import compat as jax_compat
from placement_tpu.env import fidelity as jax_fidelity
from placement_tpu.utils.config import load_experiment as jax_load
from placement_tpu_torch.agent.ppo import PPOConfig
from placement_tpu_torch.agent.trainer import Trainer
from placement_tpu_torch.env import compat, fidelity
from placement_tpu_torch.env.types import Variant
from placement_tpu_torch.parallel.mesh import Mesh
from placement_tpu_torch.utils.metrics import NullMetricsLogger
from tests.pin_environment.test_generator_fidelity import (
    CAP_BOUND, _shipped_pin_params)
from tests.test_torch_core import port_params

#: the shipped pin configs, and one cap-bound override: CAP_BOUND (area-4
#: components, skewed nets of up to 8 pins) on the fast sampler
CONFIGS = {mt: p for p, mt in _shipped_pin_params()}
CONFIGS["cap_bound"] = dataclasses.replace(CAP_BOUND, exact_sampling=False)


def test_generation_fields_are_the_jax_packages():
    assert fidelity.GENERATION_FIELDS == jax_fidelity.GENERATION_FIELDS


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_process_instances_equal_jax(name):
    """``compat.generate_instance`` after ``np.random.seed(s);
    random.seed(s)``: the same instance, array for array, on 50 seeds."""
    jp = CONFIGS[name]
    pp = port_params(jp)
    for seed in range(50):
        np.random.seed(seed)
        random.seed(seed)
        want = jax_compat.generate_instance(jp).arrays(jp)
        np.random.seed(seed)
        random.seed(seed)
        got = compat.generate_instance(pp).arrays(pp)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{name} seed {seed} {k}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_deviation_report_equals_jax(name):
    jp = CONFIGS[name]
    assert fidelity.deviation_report(port_params(jp)) == \
        jax_fidelity.deviation_report(jp)


def _checked(module, params, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ok = module.check_sampling_fidelity(params, context="ctx", **kw)
    return ok, [(w.category, str(w.message)) for w in caught]


def test_check_sampling_fidelity_equals_jax(monkeypatch):
    """The real reports (no warning, True), a deviating report (the same
    warning up to the cost note, False) and exact sampling (no report)."""
    jp = jax_load("rectangle_pin")[0]
    pp = port_params(jp)
    assert _checked(fidelity, pp) == _checked(jax_fidelity, jp) == (True, [])
    for module in (fidelity, jax_fidelity):
        monkeypatch.setattr(module, "deviation_report",
                            lambda *a, **k: (0.5, 0.01, True))
    (got_ok, got), (want_ok, want) = (_checked(fidelity, pp),
                                      _checked(jax_fidelity, jp))
    assert got_ok is want_ok is False
    assert [c for c, _ in got] == [c for c, _ in want] == [UserWarning]
    cut = "exact process ("
    assert got[0][1].split(cut)[0] == want[0][1].split(cut)[0]
    assert "cap-bound" in got[0][1] and "exact_sampling=True" in got[0][1]
    assert _checked(fidelity, pp.replace(exact_sampling=True)) == (True, [])
    square = pp.replace(variant=Variant.SQUARE)
    assert _checked(fidelity, square) == (True, [])


def _trainer(tmp_path, overrides, name="fidelity", **kw):
    return Trainer("rectangle_pin", results_root=str(tmp_path),
                   ppo_config=PPOConfig(num_envs=4, unroll_length=4,
                                        minibatch_size=8, num_sgd_iter=2),
                   env_overrides=overrides, use_tensorboard=False,
                   run_name=name, device="cpu", **kw)


def test_trainer_override_runs_the_check(tmp_path, monkeypatch):
    """An override of a generation field reaches the check, and a
    deviating report surfaces as its warning; exact sampling skips it; an
    override of no generation field does not run it."""
    calls = []

    def report(params, n_samples=512, seed=0):
        calls.append(params)
        return 0.5, 0.01, True

    monkeypatch.setattr(fidelity, "deviation_report", report)
    with pytest.warns(UserWarning, match="cap-bound"):
        _trainer(tmp_path, {"max_num_pins_per_net": 6}).close()
    assert len(calls) == 1 and calls[0].max_num_pins_per_net == 6
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        _trainer(tmp_path, {"max_num_pins_per_net": 6,
                            "exact_sampling": True}).close()
        _trainer(tmp_path, {"reward_type": "centroid"}).close()
    assert len(calls) == 1


def test_trainer_checks_and_writes_on_rank_zero_only(tmp_path, monkeypatch):
    """Rank 1 of a data-parallel run neither runs the check nor writes
    params.json or metrics (JAX's split of duties, ``:116-136``)."""
    calls = []
    monkeypatch.setattr(fidelity, "deviation_report",
                        lambda *a, **k: calls.append(a) or (0.0, 0.0, False))
    rank1 = Mesh(None, 1, 2, torch.device("cpu"))
    trainer = _trainer(tmp_path, {"max_num_pins_per_net": 6}, name="r1",
                       mesh=rank1)
    trainer.close()
    assert not trainer.is_main_process and not calls
    assert isinstance(trainer.logger, NullMetricsLogger)
    assert not os.path.exists(os.path.join(trainer.run_dir, "params.json"))
    assert trainer.learner.mesh is rank1
