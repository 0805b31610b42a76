"""The port's data-parallel learner (the learner half of
``placement_tpu_torch/parallel/mesh.py``, the sharded ``PPOLearner``, the
synced ``BatchNorm`` and the global checkpoints) on gloo CPU ranks
(``mesh.spawn_ranks``, one intra-op thread a rank), against world 1 and,
for one update, against the JAX package's ``train_step``.

One spawn a world size runs every rank-side case (``_rank_cases``); the
tests read its results. Tolerances, each stated where it is used:

* the synced ``BatchNorm`` at world n equals the one-process module on the
  global batch: outputs, input gradients, running statistics and the
  ranks' summed parameter gradients within 1e-5;
* ``shard_env_batch`` / ``place`` and ``gather_rows`` round-trip exactly;
* one sharded ``update`` fed the same rollout and permutations equals
  world 1's within ``UPDATE_TOL`` = 1e-4 (the biases that feed a batch
  norm within 2 * lr a step: ``convert.norm_fed_biases``), and fed JAX's
  rollout and permutations, JAX's ``train_step`` with the same bounds;
* one sharded ``train_step``: the six metrics of JAX's own sharded test
  (``tests/parallel/test_mesh.py:83-88``) within rtol 2e-3, atol 1e-5 of
  world 1's, and the parameters bitwise equal across the ranks.

The JAX package is imported inside the functions that use it: the spawned
ranks import this module and need only the port.
"""

import functools
import hashlib
import os

import numpy as np
import pytest
import torch

from placement_tpu_torch import graft_entry
from placement_tpu_torch.agent.policy import Policy, model_config_for
from placement_tpu_torch.agent.ppo import PPOConfig, PPOLearner, Transition
from placement_tpu_torch.agent.trainer import Trainer
from placement_tpu_torch.env import core
from placement_tpu_torch.env.types import STATE_FIELDS, EnvState
from placement_tpu_torch.models import convert
from placement_tpu_torch.models.blocks import BatchNorm, sync_batch_norm
from placement_tpu_torch.parallel import mesh
from placement_tpu_torch.utils.metrics import read_progress

BN_TOL = 1e-5
UPDATE_TOL = 1e-4
METRIC_RTOL, METRIC_ATOL = 2e-3, 1e-5
#: the metrics JAX's sharded train-step test holds to the unsharded step
METRICS = ("episode_reward_mean", "episodes_this_iter", "policy_loss",
           "vf_loss", "kl", "normalized_wirelengths_mean")
WORLDS = (2, 4)
TRAIN_KW = dict(num_envs=8, unroll_length=4, minibatch_size=8,
                num_sgd_iter=2)
TRAIN_TYPES = {2: ("rectangle_pin", "rectangle_factorized_pin"),
               4: ("rectangle_pin",)}
TINY = dict(num_envs=4, unroll_length=4, minibatch_size=8, num_sgd_iter=2)


@pytest.fixture(autouse=True)
def _one_thread_per_rank(monkeypatch):
    """Spawned ranks inherit the environment: one intra-op thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Rank-side cases (module level: the spawned ranks import them)
# ---------------------------------------------------------------------------

def _bn_case(m, case):
    """The batch norm in train mode on ``m``'s rows of the global input;
    sum(out * w) backpropagated."""
    out = {}
    for name, (x, w, p) in case.items():
        bn = BatchNorm(x.shape[1])
        with torch.no_grad():
            for k, v in p.items():
                getattr(bn, k).copy_(torch.as_tensor(v))
        bn.train()
        rows = m.rows(x.shape[0])
        if m.world > 1:
            sync_batch_norm(bn, m.group)
        xt = torch.tensor(x[rows], requires_grad=True)
        y = bn(xt)
        (y * torch.as_tensor(w[rows])).sum().backward()
        out[name] = {"out": y.detach().numpy(), "xgrad": xt.grad.numpy(),
                     "mean": bn.running_mean.numpy().copy(),
                     "var": bn.running_var.numpy().copy(),
                     "wgrad": bn.weight.grad.numpy(),
                     "bgrad": bn.bias.grad.numpy()}
    return out


def _learner(m, params, model_cfg, kw):
    return PPOLearner(params, Policy(params, model_cfg, "cpu"),
                      PPOConfig(**kw)).shard(m)


def _fields(state):
    return [getattr(state.env_states, f) for f in STATE_FIELDS] + [
        state.ep_return_acc, state.ep_len_acc]


def _roundtrip_case(m, params, model_cfg):
    """Fields that do not survive shard -> gather: an ``EnvState``
    (``shard_env_batch``) and a ``TrainState`` (``place``)."""
    states = core.reset(params, torch.Generator().manual_seed(3), 8, "cpu")
    local = mesh.shard_env_batch(m, states)
    back = mesh.gather_rows(m, [getattr(local, f) for f in STATE_FIELDS])
    bad = [f for f, b in zip(STATE_FIELDS, back)
           if not torch.equal(b, getattr(states, f))]
    learner = _learner(m, params, model_cfg, TRAIN_KW)
    whole = learner.init(torch.Generator().manual_seed(0))
    placed = learner.place(whole)
    if placed.env_states.batch != 8 // m.world:
        bad.append("placed batch")
    back = mesh.gather_rows(m, _fields(placed))
    bad += [f"train {i}" for i, (b, w) in enumerate(zip(back, _fields(whole)))
            if not torch.equal(b, w)]
    if placed.model is not whole.model or placed.gen is not whole.gen:
        bad.append("whole parts")
    return bad


def _update_case(m, case):
    """One update fed the case's rollout (this rank's boards) and
    permutations, from the case's Flax variables."""
    learner = _learner(m, case["params"], case["model_cfg"], case["kw"])
    state = learner.place(learner.init(torch.Generator().manual_seed(0),
                                       case["variables"]))
    rows = m.rows(case["last_value"].shape[0])
    traj = {k: ({o: torch.tensor(x[:, rows]) for o, x in v.items()}
                if k == "obs" else torch.tensor(v[:, rows]))
            for k, v in case["traj"].items()}
    state, metrics = learner.update(
        state, Transition(**traj), torch.tensor(case["last_value"][rows]),
        perms=[torch.tensor(p) for p in case["perms"]])
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "vars": convert.to_flax(state.model.state_dict()),
            "kl_coeff": float(state.kl_coeff)}


def _digest(module):
    h = hashlib.sha256()
    for k, v in module.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _train_case(m, params, model_type):
    """One sharded ``train_step`` from a generator seeded 0: its metrics and
    a digest of the parameters, each held equal to rank 0's."""
    learner = _learner(m, params, model_config_for(params, model_type),
                       TRAIN_KW)
    state = learner.place(learner.init(torch.Generator().manual_seed(0)))
    state, metrics = learner.train_step(state)
    check = mesh.replicated(m)
    for v in state.model.state_dict().values():
        check(v)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "digest": _digest(state.model)}


def _rank_cases(rank, world, bn, update, params):
    torch.set_num_threads(1)
    m = mesh.make_mesh(world, "cpu")
    return {"bn": _bn_case(m, bn),
            "roundtrip": _roundtrip_case(
                m, params, model_config_for(params, "rectangle_pin")),
            "update": _update_case(m, update),
            "train": {t: _train_case(m, params, t)
                      for t in TRAIN_TYPES[world]}}


# ---------------------------------------------------------------------------
# Inputs, world 1 and the spawned worlds (cached: one spawn a world)
# ---------------------------------------------------------------------------

def _bn_inputs():
    rng = np.random.default_rng(0)
    out = {}
    for name, shape in (("conv", (8, 3, 4, 5)), ("flat", (8, 6))):
        c = shape[1]
        x = rng.normal(0.5, 2.0, shape).astype(np.float32)
        w = rng.normal(size=shape).astype(np.float32)
        p = {"weight": rng.uniform(0.5, 2.0, c).astype(np.float32),
             "bias": rng.normal(size=c).astype(np.float32),
             "running_mean": rng.normal(size=c).astype(np.float32),
             "running_var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
        out[name] = (x, w, p)
    return out


@functools.lru_cache(maxsize=None)
def _jax_update_case():
    """JAX's rollout on the 6x6 PIN env of ``tests/agent/test_ppo.py``, its
    permutations, its ``train_step``'s result and the Flax variables it
    started from (the case of
    ``test_torch_learner.py::test_update_matches_jax_train_step``)."""
    import jax

    from placement_tpu.agent.policy import model_config_for as jax_config
    from tests.agent.test_models import PIN
    from tests.test_torch_core import port_params
    from tests.test_torch_learner import _learners
    from tests.test_torch_models import port_config

    params = PIN.replace(reward_type="centroid")
    jax_cfg = jax_config(params, "rectangle_pin")
    jl, learner = _learners("rectangle_pin", params, jax_cfg)
    state = jl.init(jax.random.PRNGKey(0))
    rolled, traj, last_value, _ = jax.jit(jl._rollout)(state)
    _, k_sgd = jax.random.split(rolled.key)
    perms = [np.asarray(jax.random.permutation(k, 64))
             for k in jax.random.split(k_sgd, 2)]
    want_state, want = jax.jit(jl.train_step)(state)
    case = {
        "params": port_params(params), "model_cfg": port_config(jax_cfg),
        "kw": dict(num_envs=8, unroll_length=8, minibatch_size=16,
                   num_sgd_iter=2),
        "variables": jax.tree_util.tree_map(
            np.asarray, jax.device_get(state.variables)),
        "traj": jax.tree_util.tree_map(np.asarray, traj._asdict()),
        "last_value": np.asarray(last_value), "perms": perms,
    }
    from placement_tpu_torch.models import convert as port_convert
    jax_out = {"metrics": {k: float(want[k]) for k in (
        "policy_loss", "vf_loss", "entropy", "kl", "kl_coeff")},
        "vars": port_convert.flatten(jax.device_get(want_state.variables)),
        "kl_coeff": float(want_state.kl_coeff)}
    return case, jax_out, learner.cfg.lr


@functools.lru_cache(maxsize=None)
def _world_one():
    m = mesh.make_mesh(1, "cpu")
    params = graft_entry.dryrun_params()
    case, _, _ = _jax_update_case()
    return {"bn": _bn_case(m, _bn_inputs()),
            "update": _update_case(m, case),
            "train": {t: _train_case(m, params, t)
                      for t in TRAIN_TYPES[2]}}


@functools.lru_cache(maxsize=None)
def _world(world):
    case, _, _ = _jax_update_case()
    return mesh.spawn_ranks(
        _rank_cases, world,
        args=(_bn_inputs(), case, graft_entry.dryrun_params()))


def _close(got, want, atol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= atol, (what, err, atol)


# ---------------------------------------------------------------------------
# (a) the synced batch norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_synced_batch_norm_equals_one_process_on_the_global_batch(world):
    """Flax's rule over the ranks: the global batch's biased statistics
    in the normalisation and in the running variance (the ranks' sums,
    sums of squares and counts in one autograd-aware all-reduce)."""
    want = _world_one()["bn"]
    ranks = _world(world)
    for name, w in want.items():
        rows = 8 // world
        for r, res in enumerate(ranks):
            got = res["bn"][name]
            sl = slice(r * rows, (r + 1) * rows)
            _close(got["out"], w["out"][sl], BN_TOL, (name, r, "out"))
            _close(got["xgrad"], w["xgrad"][sl], BN_TOL, (name, r, "xgrad"))
            for k in ("mean", "var"):
                _close(got[k], w[k], BN_TOL, (name, r, k))
        for k in ("wgrad", "bgrad"):
            _close(sum(res["bn"][name][k] for res in ranks), w[k], BN_TOL,
                   (name, k))


def test_batch_norm_without_a_group_is_unchanged():
    """No group: the module's train forward is the one-process code, bit
    for bit (``sync_batch_norm(module, None)`` restores it)."""
    x, w, p = _bn_inputs()["conv"]
    outs = []
    for group in ("unset", None):
        bn = BatchNorm(x.shape[1])
        with torch.no_grad():
            for k, v in p.items():
                getattr(bn, k).copy_(torch.as_tensor(v))
        if group is None:
            sync_batch_norm(bn, None)
        bn.train()
        outs.append((bn(torch.as_tensor(x)), bn.running_var.clone()))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


# ---------------------------------------------------------------------------
# (b) shard_env_batch and place
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_shard_env_batch_and_place_round_trip(world):
    for r, res in enumerate(_world(world)):
        assert res["roundtrip"] == [], (r, res["roundtrip"])


def test_batch_sharding_takes_the_rank_rows():
    m = mesh.Mesh(None, 1, 4, torch.device("cpu"))
    x = torch.arange(16).reshape(8, 2)
    assert torch.equal(mesh.batch_sharding(m)(x), x[2:4])
    one = mesh.make_mesh(device="cpu")
    assert (one.rank, one.world, one.group) == (0, 1, None)
    assert mesh.replicated(one)(x) is x
    assert mesh.gather_rows(one, [x])[0] is x


# ---------------------------------------------------------------------------
# (c) one sharded update
# ---------------------------------------------------------------------------

def _assert_update_close(got, want, lr, steps, what):
    for k, v in want["metrics"].items():
        _close(got["metrics"][k], v, UPDATE_TOL * max(1.0, abs(v)),
               (what, k))
    assert got["kl_coeff"] == want["kl_coeff"], what
    noise = convert.norm_fed_biases(want["vars"])
    assert set(got["vars"]) == set(want["vars"])
    for k in want["vars"]:
        tol = 2 * lr * steps if k in noise else UPDATE_TOL
        _close(got["vars"][k], want["vars"][k], tol, (what, k))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_update_equals_world_one_and_jax(world):
    """JAX's rollout and permutations through world n's ``update`` (each
    rank fed its boards): world 1's result and JAX's ``train_step``'s
    within 1e-4, the norm-fed biases within 2 * lr a step; the same on
    every rank."""
    case, jax_out, lr = _jax_update_case()
    steps = 2 * 64 // 16
    one = _world_one()["update"]
    _assert_update_close(one, jax_out, lr, steps, "world 1 vs JAX")
    ranks = _world(world)
    for r, res in enumerate(ranks):
        _assert_update_close(res["update"], one, lr, steps, f"rank {r}")
        _assert_update_close(res["update"], jax_out, lr, steps,
                             f"rank {r} vs JAX")
        assert res["update"]["metrics"] == ranks[0]["update"]["metrics"]
        for k, v in res["update"]["vars"].items():
            np.testing.assert_array_equal(v, ranks[0]["update"]["vars"][k])


# ---------------------------------------------------------------------------
# (d) one sharded train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,model_type", [
    (w, t) for w in WORLDS for t in TRAIN_TYPES[w]])
def test_sharded_train_step_equals_world_one(world, model_type):
    """``dryrun_multichip``'s config, 8 boards x 4 steps, 2 epochs of
    minibatches of 8: the six metrics of JAX's sharded test within rtol
    2e-3 and atol 1e-5 of world 1's (the factorized preset's sampled
    entropy and KL drawn at the whole minibatch's shape), every metric the
    same on every rank, the parameters bitwise equal across the ranks."""
    want = _world_one()["train"][model_type]
    ranks = [res["train"][model_type] for res in _world(world)]
    for k in METRICS:
        np.testing.assert_allclose(ranks[0]["metrics"][k],
                                   want["metrics"][k], rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL, err_msg=k)
    assert want["metrics"]["episodes_this_iter"] > 0
    assert want["metrics"]["pool_wraps"] == 0
    for res in ranks[1:]:
        assert res == ranks[0]


# ---------------------------------------------------------------------------
# (e) divisibility
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,field", [
    (dict(num_envs=8, minibatch_size=6), "num_envs 8"),
    (dict(num_envs=6, minibatch_size=8), "minibatch_size 8")])
def test_ranks_must_divide_the_boards_and_the_minibatch(kw, field):
    params = graft_entry.dryrun_params()
    learner = PPOLearner(params, Policy(
        params, model_config_for(params, "rectangle_pin"), "cpu"),
        PPOConfig(unroll_length=2, **kw))
    with pytest.raises(ValueError, match=f"{field} not divisible by 3"):
        mesh.shard_learner(learner, mesh.Mesh(None, 0, 3,
                                              torch.device("cpu")))


def test_make_mesh_is_one_process_a_rank():
    with pytest.raises(ValueError, match="one process is one rank"):
        mesh.make_mesh(2, "cpu")


# ---------------------------------------------------------------------------
# (f) the dry run
# ---------------------------------------------------------------------------

def test_dryrun_multigpu_runs_both_halves_on_cpu_ranks():
    results = graft_entry.dryrun_multigpu(2, device="cpu")
    assert len(results) == 2
    assert results[0]["metrics"] == results[1]["metrics"]
    assert set(results[0]["metrics"]) >= set(METRICS)
    assert all(np.isfinite(v) for v in results[0]["metrics"].values())
    for res in results:
        assert res["launches"] == 0
        assert np.isfinite(res["totals"][0][0])


# ---------------------------------------------------------------------------
# (g) checkpoints of the global state
# ---------------------------------------------------------------------------

def _state_arrays(state):
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"opt/{i}/{k}": torch.as_tensor(v)
                    for k, v in s.items()})
    out.update({f"env/{f}": getattr(state.env_states, f)
                for f in STATE_FIELDS})
    out.update(kl_coeff=state.kl_coeff, gen=state.gen.get_state(),
               ret=state.ep_return_acc, len=state.ep_len_acc,
               steps=torch.tensor(state.steps))
    return {k: v.detach().numpy().copy() for k, v in out.items()}


def _trainer(root, name, m=None):
    return Trainer("rectangle_pin", results_root=root,
                   ppo_config=PPOConfig(**TINY), run_name=name,
                   device="cpu", use_tensorboard=False, mesh=m)


def _checkpoint_rank(rank, world, root):
    """2 iterations straight; 1, a checkpoint, a restore into a new trainer
    and 1 more; each rank's state after both, and the rows logged."""
    torch.set_num_threads(1)
    m = mesh.make_mesh(world, "cpu")
    straight = _trainer(root, "straight", m)
    rows = []
    want = straight.run(2, seed=3, on_iteration=lambda i, r: rows.append(r))
    straight.close()
    first = _trainer(root, "split", m)
    first.run(1, seed=3)
    first.close()
    second = _trainer(root, "split", m)
    state = second.restore()
    got_rows = []
    got = second.run(1, state=state,
                     on_iteration=lambda i, r: got_rows.append((i, r)))
    second.close()
    return {"want": _state_arrays(want.state), "got": _state_arrays(got.state),
            "rows": rows, "got_rows": got_rows,
            "main": straight.is_main_process}


def test_checkpoints_hold_the_global_state(tmp_path):
    """A world-2 run: one progress.csv (rank 0's), its checkpoints; 1 + 1
    iterations across a restore at world 2 equal 2 straight ones bit for
    bit on each rank; the checkpoint holds both ranks' boards and loads at
    world 1, which trains on from it."""
    root = str(tmp_path)
    ranks = mesh.spawn_ranks(_checkpoint_rank, 2, args=(root,))
    assert [r["main"] for r in ranks] == [True, False]
    for r, res in enumerate(ranks):
        assert set(res["got"]) == set(res["want"])
        for k, v in res["want"].items():
            np.testing.assert_array_equal(res["got"][k], v,
                                          err_msg=f"rank {r} {k}")
        assert [i for i, _ in res["got_rows"]] == [2]
        drop = ("time_total_s",)
        assert ({k: v for k, v in res["got_rows"][0][1].items()
                 if k not in drop}
                == {k: v for k, v in res["rows"][1].items() if k not in drop})
    run_dir = os.path.join(root, "PPO", "straight")
    cols = read_progress(run_dir)
    assert list(cols["training_iteration"]) == [1, 2]
    assert os.path.exists(os.path.join(run_dir, "params.json"))
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == [
        "checkpoint_1", "checkpoint_2"]
    one = _trainer(root, "world1")
    try:
        state = one.restore(run_dir=os.path.join(root, "PPO", "split"))
        assert state.env_states.batch == TINY["num_envs"]
        for f in STATE_FIELDS:
            np.testing.assert_array_equal(
                getattr(state.env_states, f).numpy(),
                np.concatenate([res["got"][f"env/{f}"] for res in ranks]),
                err_msg=f)
        np.testing.assert_array_equal(
            state.ep_return_acc.numpy(),
            np.concatenate([res["got"]["ret"] for res in ranks]))
        for k, v in ranks[0]["got"].items():
            if k.startswith(("model/", "opt/")):
                np.testing.assert_array_equal(_state_arrays(state)[k], v,
                                              err_msg=k)
        result = one.run(1, state=state)
        assert result.state.steps == 3 * TINY["num_envs"] * 4
        assert np.isfinite(result.final_metrics["policy_loss"])
    finally:
        one.close()


def test_shard_env_batch_copies_the_rows():
    """``shard_env_batch`` copies: a rank's boards own their storage, so a
    checkpoint of the shard never serialises the whole batch."""
    params = graft_entry.dryrun_params()
    states = core.reset(params, torch.Generator().manual_seed(0), 4, "cpu")
    local = mesh.shard_env_batch(mesh.Mesh(None, 1, 2, torch.device("cpu")),
                                 states)
    assert isinstance(local, EnvState) and local.batch == 2
    assert local.grid.untyped_storage().nbytes() == local.grid.nbytes
    assert torch.equal(local.grid, states.grid[2:])
