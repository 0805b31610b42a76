"""The port's gym-style adapter (``placement_tpu_torch.env.gym_api``) against
the JAX package's ``PlacementEnv``: the six cases of
``tests/tooling/test_gym_api.py``, each played by both adapters from the
same board (the JAX reset state carried across with ``state_from_numpy``:
the two random streams differ). Observations equal, rewards and infos
within 1e-5 (f32 sums in another order), done flags equal.
"""

import numpy as np
import pytest
import torch

from placement_tpu.env import gym_api as jax_gym
from placement_tpu.env.types import EnvParams as JaxParams
from placement_tpu.env.types import Variant as JaxVariant
from placement_tpu_torch.env import gym_api
from placement_tpu_torch.env.types import STATE_FIELDS, state_from_numpy
from tests.test_torch_core import port_params


def _carry(jenv, env):
    """Put the JAX env's board into the port's env; returns its obs."""
    env.state = state_from_numpy(
        {f: np.asarray(getattr(jenv.state, f))[None] for f in STATE_FIELDS},
        "cpu")
    return env._obs()


def _same_obs(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if k == "all_components_feature":        # area ratio: 1e-6
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def _same_step(got, want):
    (obs, r, d, info), (jobs, jr, jd, jinfo) = got, want
    _same_obs(obs, jobs)
    assert isinstance(r, float) and isinstance(d, bool)
    assert abs(r - jr) <= 1e-5 and d == jd
    assert set(info) == set(jinfo)
    for k in info:
        assert abs(info[k] - jinfo[k]) <= 1e-5 * max(1.0, abs(jinfo[k])), k


def _pair(make_jax, make_port):
    jenv, env = make_jax(), make_port()
    jobs = jenv.reset()
    env.reset()
    _same_obs(_carry(jenv, env), jobs)
    return jenv, env


def _square(h, w):
    jp = JaxParams(variant=JaxVariant.SQUARE, height=h, width=w,
                   component_n=2)
    return (lambda: jax_gym.PlacementEnv(jp, seed=0),
            lambda: gym_api.PlacementEnv(port_params(jp), seed=0,
                                         device="cpu"))


def test_square_episode():
    jenv, env = _pair(*_square(6, 6))
    assert env._obs()["grid"].shape == (6, 6)
    assert env.action_mask.shape == (6, 6)
    total, done, steps = 0.0, False, 0
    while not done:
        x, y = np.argwhere(jenv.action_mask == 1)[0]
        np.testing.assert_array_equal(env.action_mask, jenv.action_mask)
        got = env.step((int(x), int(y)))
        _same_step(got, jenv.step((int(x), int(y))))
        total += got[1]
        done = got[2]
        steps += 1
        assert steps <= 9
    # a 6x6 grid greedily packed with 2x2 -> 9 placements, +1 reward each
    assert total == 9.0


def test_pin_episode_terminal_info():
    jenv, env = _pair(lambda: jax_gym.make("rectangle_pin", seed=1),
                      lambda: gym_api.make("rectangle_pin", seed=1,
                                           device="cpu"))
    assert set(env._obs()) >= {"grid", "action_mask",
                               "all_components_feature", "placement_mask",
                               "all_pins_num_feature", "all_pins_cat_feature"}
    rng = np.random.default_rng(0)
    done = False
    while not done:
        valid = np.argwhere(jenv.action_mask == 1)
        o, x, y = (int(v) for v in valid[rng.integers(len(valid))])
        assert env.validate_action((o, x, y)) and jenv.validate_action(
            (o, x, y))
        got = env.step((o, x, y))
        _same_step(got, jenv.step((o, x, y)))
        _, r, done, info = got
        np.testing.assert_array_equal(env.grid, jenv.grid)
    assert "wirelength" in info and "num_intersections" in info
    assert r <= 0.0                                  # routing penalty reward


def test_invalid_action_square_semantics():
    jenv, env = _pair(*_square(5, 5))
    # a 2x2 cannot sit at the corner (4, 4): dummy_env_square.py:134-140
    assert not env.validate_action((4, 4))
    got = env.step((4, 4))
    _same_step(got, jenv.step((4, 4)))
    _, r, done, info = got
    assert r == 0.0 and done and info == {}


def test_flat_action_wrapper_parity():
    jenv, env = _pair(
        lambda: jax_gym.make("rectangle_pin", seed=3, flatten_actions=True),
        lambda: gym_api.make("rectangle_pin", seed=3, flatten_actions=True,
                             device="cpu"))
    obs = env._obs()
    assert obs["action_mask"].shape == (env.action_size,)
    a = int(np.argwhere(obs["action_mask"] == 1)[0][0])
    got = env.step(a)
    _same_step(got, jenv.step(a))
    assert got[0]["action_mask"].ndim == 1
    assert env.action_size == jenv.action_size
    assert env.action_shape == jenv.action_shape


def test_seed_determinism():
    """Equal seeds give equal boards (the port's own stream), with JAX's
    observation keys, shapes and types."""
    o1 = gym_api.make("rectangle_pin", seed=7, device="cpu").reset()
    o2 = gym_api.make("rectangle_pin", seed=7, device="cpu").reset()
    o3 = gym_api.make("rectangle_pin", seed=8, device="cpu").reset()
    want = jax_gym.make("rectangle_pin", seed=7).reset()
    for k in o1:
        np.testing.assert_array_equal(o1[k], o2[k])
        assert o1[k].shape == want[k].shape and o1[k].dtype == want[k].dtype
    assert any(not np.array_equal(o1[k], o3[k]) for k in o1)


def test_make_overrides():
    env = gym_api.make("rectangle_pin", height=12, width=11, device="cpu")
    assert env.params.height == 12 and env.params.width == 11
    assert env.reset()["grid"].shape == (12, 11)
    with pytest.raises(ValueError):
        gym_api.make("rectangle_pin", height=-1, device="cpu")


def test_gym_api_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gym_api.make("rectangle_pin")
    with pytest.raises(RuntimeError, match="step"):
        gym_api.make("rectangle_pin", device="cpu").step(0)
