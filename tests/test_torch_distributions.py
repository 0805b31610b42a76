"""The port's action distributions (``placement_tpu_torch.models.
distributions``) against the JAX package's.

* ``cat_logp``, ``cat_entropy`` and ``cat_kl`` equal JAX's on the same
  logits (masked entries at f32's lowest value included) within 1e-5.
* ``Factorized.logp`` equals JAX's on the same legal actions, in both
  orders, with the factorized model's heads carried from Flax (1e-5);
  ``deterministic=True`` samples equal JAX's exactly.
* Stochastic samples (Gumbel-max from a ``torch.Generator``; JAX's stream is
  not reproduced) are legal in every one of >= 10^4 draws, and their
  frequencies pass a chi-square test against the exact probabilities
  (p > 1e-3, seeded).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from placement_tpu.agent.policy import Policy as JaxPolicy
from placement_tpu.agent.policy import model_config_for as jax_model_config
from placement_tpu.models import distributions as JD
from placement_tpu_torch.models import distributions as D
from tests.agent.test_models import PIN
from tests.test_torch_models import (
    carried, flax_variables, jax_obs, port_config)

NEG = np.finfo(np.float32).min
TOL = 1e-5
DRAWS = 20_000


def _logits(rng, shape, masked=0.3):
    x = rng.normal(0.0, 2.0, shape).astype(np.float32)
    x[rng.random(shape) < masked] = NEG
    x[..., 0] = rng.normal(0.0, 2.0, shape[:-1])      # one legal per row
    return x


def test_categorical_functions_match_jax():
    rng = np.random.default_rng(0)
    p, q = _logits(rng, (64, 37)), _logits(rng, (64, 37), masked=0.0)
    idx = np.array([rng.choice(np.flatnonzero(r > NEG)) for r in p])
    t = torch.as_tensor
    np.testing.assert_allclose(D.cat_logp(t(p), t(idx)).numpy(),
                               np.asarray(JD.cat_logp(p, idx)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(D.cat_entropy(t(p)).numpy(),
                               np.asarray(JD.cat_entropy(p)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(D.cat_kl(t(q), t(p)).numpy(),
                               np.asarray(JD.cat_kl(q, p)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(D.cat_argmax(t(p)).numpy(),
                                  np.asarray(JD.cat_argmax(p)))


def _chi_square_p(counts, expected):
    """p-value of observed ``counts`` against ``expected`` (same total),
    cells expected below 5 pooled into one."""
    expected = np.asarray(expected, np.float64)
    small = expected < 5
    obs = np.append(counts[~small], counts[small].sum())
    exp = np.append(expected[~small], expected[small].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    exp = exp / exp.sum() * obs.sum()
    exp[-1] = obs.sum() - exp[:-1].sum()
    return stats.chisquare(obs, exp).pvalue


def test_cat_sample_is_legal_and_follows_the_softmax():
    rng = np.random.default_rng(1)
    row = _logits(rng, (12,), masked=0.4)
    row[:3] = [0.5, -1.0, 1.5]
    logits = torch.as_tensor(np.tile(row, (DRAWS, 1)))
    got = D.cat_sample(torch.Generator().manual_seed(2), logits).numpy()
    assert (row[got] > NEG).all()
    probs = np.asarray(jax.nn.softmax(row))
    counts = np.bincount(got, minlength=row.size).astype(np.float64)
    assert _chi_square_p(counts, probs * DRAWS) > 1e-3


# ---------------------------------------------------------------------------
# Factorized, with the factorized model's heads carried from Flax
# ---------------------------------------------------------------------------

def _factorized(order):
    """JAX and port distributions of the same boards: the
    ``rectangle_factorized_pin`` heads (Flax init, carried), JAX's encoding
    and mask."""
    jax_cfg = jax_model_config(PIN, "rectangle_factorized_pin",
                               factorization=order)
    _, obs = jax_obs(PIN, b=16, steps=1)
    variables = flax_variables(jax_cfg, PIN, obs)
    jpol = JaxPolicy(PIN, jax_cfg)
    enc = jpol.model.apply(variables, obs, train=False)["encoding"]
    jdist = jpol._factorized_dist(variables, enc, obs["action_mask"])
    model = carried(jax_cfg, variables)
    cfg = port_config(jax_cfg)
    heads = D.FactorizedHeads(model.o_logits, model.x_logits, model.y_logits,
                              cfg.num_orientations, cfg.height, cfg.width)
    dist = D.Factorized(heads, torch.as_tensor(np.asarray(enc)),
                        torch.as_tensor(obs["action_mask"]), order)
    return jdist, dist, obs["action_mask"]


def _legal(rng, mask):
    return np.stack([np.argwhere(m)[rng.integers(int(m.sum()))]
                     for m in mask]).astype(np.int32)


@pytest.mark.parametrize("order", ["orientation", "coordinates"])
def test_factorized_logp_and_greedy_match_jax(order):
    jdist, dist, mask = _factorized(order)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for _ in range(3):
            a = _legal(rng, mask)
            np.testing.assert_allclose(
                dist.logp(torch.as_tensor(a)).numpy(),
                np.asarray(jdist.logp(jnp.asarray(a))), rtol=TOL, atol=TOL)
        greedy = dist.sample(torch.Generator(), deterministic=True).numpy()
        want = np.asarray(jdist.sample(jax.random.PRNGKey(0),
                                       deterministic=True))
        np.testing.assert_array_equal(greedy, want)
        # entropy and KL: the same functions of the logits (checked at
        # the greedy conditionals, where both sample the same factors)
        ent = dist.entropy(torch.Generator().manual_seed(0))
        assert torch.isfinite(ent).all() and (ent >= -TOL).all()
        kl = dist.kl(dist, torch.Generator().manual_seed(0))
        np.testing.assert_allclose(kl.numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("order", ["orientation", "coordinates"])
def test_factorized_entropy_and_kl_match_jax_factor_by_factor(order):
    """The stochastic entropy and KL sum per-factor categorical terms at
    sampled earlier factors; at the same factors (fixed here) both
    frameworks' sums agree."""
    jdist, dist, mask = _factorized(order)
    rng = np.random.default_rng(4)
    a = _legal(rng, mask)
    t = torch.as_tensor
    o, x, y = a[:, 0], a[:, 1], a[:, 2]
    with torch.no_grad():
        if order == "orientation":
            got = dist._logits_chain_orientation(o=t(o), x=t(x))
            want = jdist._logits_chain_orientation(o=o, x=x)
        else:
            got = dist._logits_chain_coordinates(x=t(x), y=t(y))
            want = jdist._logits_chain_coordinates(x=x, y=y)
        for g, w in zip(got, want):
            np.testing.assert_allclose(D.cat_entropy(g).numpy(),
                                       np.asarray(JD.cat_entropy(w)),
                                       rtol=TOL, atol=TOL)
            shifted = g * 0.5
            np.testing.assert_allclose(
                D.cat_kl(g, shifted).numpy(),
                np.asarray(JD.cat_kl(w, jnp.asarray(shifted.numpy()))),
                rtol=TOL, atol=TOL)


@pytest.mark.parametrize("order", ["orientation", "coordinates"])
def test_factorized_samples_are_legal_and_follow_the_joint(order):
    """>= 10^4 draws of one board: every action legal, frequencies against
    exp(logp) over all legal actions."""
    _, dist, mask = _factorized(order)
    board = int(np.argmax(mask.reshape(len(mask), -1).sum(1)))
    rep = D.Factorized(dist.heads, dist.enc[board:board + 1].expand(DRAWS, -1),
                       dist.mask[board:board + 1].expand(DRAWS, -1, -1, -1),
                       order)
    with torch.no_grad():
        a = rep.sample(torch.Generator().manual_seed(5)).numpy()
        m = mask[board]
        assert m[a[:, 0], a[:, 1], a[:, 2]].all()
        legal = np.argwhere(m)
        one = D.Factorized(dist.heads,
                           dist.enc[board:board + 1].expand(len(legal), -1),
                           dist.mask[board:board + 1].expand(
                               len(legal), -1, -1, -1), order)
        probs = torch.exp(one.logp(torch.as_tensor(legal))).numpy()
    assert abs(probs.sum() - 1.0) < 1e-4
    o_, x_, y_ = m.shape
    flat = (a[:, 0] * x_ + a[:, 1]) * y_ + a[:, 2]
    counts = np.bincount(flat, minlength=m.size)[
        (legal[:, 0] * x_ + legal[:, 1]) * y_ + legal[:, 2]]
    assert counts.sum() == DRAWS
    assert _chi_square_p(counts.astype(np.float64), probs * DRAWS) > 1e-3


@pytest.mark.parametrize("order", ["orientation", "coordinates"])
def test_all_masked_board_acts_as_jax(order):
    """A board with no legal action (a finished board still stepped): the
    greedy factors are JAX's and the logp is finite; the board is done and
    its action is ignored."""
    jdist, dist, mask = _factorized(order)
    empty = np.zeros_like(mask)
    jdist.mask = jnp.asarray(empty)
    dist.mask = torch.as_tensor(empty)
    with torch.no_grad():
        greedy = dist.sample(torch.Generator(), deterministic=True)
        drawn = dist.sample(torch.Generator().manual_seed(6))
        np.testing.assert_array_equal(
            greedy.numpy(), np.asarray(jdist.sample(jax.random.PRNGKey(0),
                                                    deterministic=True)))
        for a in (greedy, drawn):
            assert torch.isfinite(dist.logp(a)).all()
            assert ((a >= 0) & (a < torch.tensor(mask.shape[1:]))).all()
