"""The port's greedy rollout sampling (``placement_tpu_torch.viz.rollout``)
against the JAX package's ``sample_rollout``.

JAX plays its five greedy episodes of the flagship policy (the fixture's
Flax variables) from boards drawn by its key splits; the port plays the
same five boards (carried across with ``state_from_numpy``) with the
weights carried across (``Policy.load_flax``). The component and pin
records and every greedy action are equal; the terminal infos and rewards
agree within 1e-5. The file helpers round-trip the records and write JAX's
CSV.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from placement_tpu.agent.policy import Policy as JaxPolicy
from placement_tpu.env import core as jax_core
from placement_tpu.utils import config as jax_config
from placement_tpu.viz import rollout as jax_rollout
from placement_tpu_torch.agent.policy import Policy
from placement_tpu_torch.env.types import STATE_FIELDS, state_from_numpy
from placement_tpu_torch.viz import rollout
from tests.test_torch_core import port_params
from tests.test_torch_models import port_config
from tests.test_torch_policy import fixture

SAMPLES = 5


def _flagship():
    params, cfg, _ = jax_config.load_experiment("rectangle_pin")
    variables, _, _ = fixture()
    policy = Policy(port_params(params), port_config(cfg), "cpu")
    return params, cfg, variables, policy.load_flax(variables)


def _records(episodes):
    """Component records as dicts (the two packages' classes differ)."""
    return [[dataclasses.asdict(c) for c in comps] for comps in episodes]


def test_greedy_episodes_match_jax():
    params, cfg, variables, policy = _flagship()
    want_c, want_a, want_i = jax_rollout.sample_rollout(
        params, JaxPolicy(params, cfg), variables, num_samples=SAMPLES,
        seed=0)
    boards = _jax_states_of(params, want_c, [len(a) for a in want_a])
    got_c, got_a, got_i = rollout.play_episodes(
        port_params(params), policy, boards, torch.Generator())
    assert _records(got_c) == _records(want_c)
    assert got_a == want_a
    assert len(got_i) == len(want_i)
    for g, w in zip(got_i, want_i):
        assert set(g) == set(w) == {"wirelength", "num_intersections",
                                    "reward"}
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-5 * max(1.0, abs(w[k])), k


def _jax_states_of(params, want_components, lengths):
    """The reset boards of JAX's ``sample_rollout(seed=0)``: its loop splits
    the key once for each board and once for each step's action
    (``viz/rollout.py:106-118``), so each board's key follows the previous
    episode's length."""
    key = jax.random.PRNGKey(0)
    states = []
    for n in lengths:
        key, k_env = jax.random.split(key)
        states.append(jax_core.reset(params, k_env))
        for _ in range(n):
            key, _ = jax.random.split(key)
    out = state_from_numpy(
        {f: np.stack([np.asarray(getattr(s, f)) for s in states])
         for f in STATE_FIELDS}, "cpu")
    for i, want in enumerate(want_components):
        assert _records([rollout.components_from_state(
            port_params(params), out, i)]) == _records([want])
    return out


def test_sample_rollout_plays_legal_greedy_episodes(tmp_path):
    params, cfg, _, policy = _flagship()
    comps, actions, infos = rollout.sample_rollout(
        port_params(params), policy, num_samples=3, seed=2, device="cpu")
    assert len(comps) == len(actions) == len(infos) == 3
    for c, a, info in zip(comps, actions, infos):
        assert len(c) == params.max_num_components
        assert sum(len(comp.pins) for comp in c) == \
            params.max_num_nets * params.max_num_pins_per_net
        assert 1 <= len(a) <= params.max_components
        assert all(isinstance(v, int) for step in a for v in step)
        assert info["reward"] <= 0.0
    again = rollout.sample_rollout(port_params(params), policy,
                                   num_samples=3, seed=2, device="cpu")
    assert again[:2] == (comps, actions)
    rollout.save_to_file(str(tmp_path), comps, actions)
    _, a2, c2 = rollout.load_pickle(str(tmp_path))
    assert (a2, c2) == (actions, comps)


def test_save_config_to_csv_matches_jax(tmp_path):
    _, _, raw = jax_config.load_experiment("rectangle_pin")
    env_cfg, model_cfg = raw["env_config"], raw["model"]["custom_model_config"]
    rollout.save_config_to_csv(str(tmp_path / "port.csv"), env_cfg, model_cfg)
    jax_rollout.save_config_to_csv(str(tmp_path / "jax.csv"), env_cfg,
                                   model_cfg)
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "jax.csv").read_text()


def test_sample_rollout_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    params, _, _, policy = _flagship()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rollout.sample_rollout(port_params(params), policy)
