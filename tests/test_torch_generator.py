"""The port's instance generator (``placement_tpu_torch.env.generator``),
held by distribution: the ``jax.random`` stream is not reproduced.

* Invariants of every reset on the cap-bound config of
  ``tests/pin_environment/test_generator_fidelity.py`` (both samplers), the
  shipped configs and the parity recordings' geometry.
* The exact and the fast capped multinomial against ``env/compat.py``'s
  NumPy reference process (test_generator_fidelity.py:53-80: chi-square
  p > 1e-3 and TVD < 0.05 for the exact one, TVD < 0.35 and marginal means
  within 0.15 for the fast one); the exact sampler's per-net pin counts
  against the compat pipeline.
* The port's reset signatures (sorted pins per component + pins per net),
  with either sampler, against the JAX ``reset`` on every shipped pin config
  and the parity geometry: TVD within the same-distribution noise of two
  JAX seeds + 0.03 (:182-198).
"""

import dataclasses
import functools
import random

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from placement_tpu.env import compat
from placement_tpu.env import core as jax_core
from placement_tpu_torch.env import core, generator
from placement_tpu_torch.env.types import EnvParams, Variant
from tests.parity.test_reference_parity import PARAMS as PARITY
from tests.pin_environment.test_generator_fidelity import (
    BINS, CAP, CAP_BOUND, N_SAMPLES, PROBS, TRIALS, _hist, _reference_hist,
    _shipped_pin_params, _tvd)
from tests.test_torch_core import port_params

N_RESETS = 2048


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# Reset invariants
# ---------------------------------------------------------------------------

def _assert_instance_invariants(params: EnvParams, s):
    b = s.batch
    c = params.max_components
    numc = s.num_components.numpy()
    h, w = s.comp_h.numpy(), s.comp_w.numpy()
    assert ((params.min_num_components <= numc)
            & (numc <= params.max_num_components)).all()
    valid = np.arange(c)[None, :] < numc[:, None]
    assert (((params.min_component_h <= h) & (h <= params.max_component_h))
            | ~valid).all() and (h[~valid] == 0).all()
    assert (((params.min_component_w <= w) & (w <= params.max_component_w))
            | ~valid).all() and (w[~valid] == 0).all()
    assert (s.comp_x.numpy() == -1).all() and (s.cursor.numpy() == 0).all()
    for i in range(b):
        _assert_board_pins(params, s, i)
    assert torch.equal(s.pin_rel_x0, s.pin_rel_x)
    assert (s.pin_abs_x.numpy() == -1).all()


def _assert_board_pins(params: EnvParams, s, i):
    """Board ``i``'s pin table: a net-grouped prefix, pins per net in range,
    every component's pins on distinct cells inside it."""
    net, comp = s.pin_net[i].numpy(), s.pin_comp[i].numpy()
    rx, ry = s.pin_rel_x[i].numpy(), s.pin_rel_y[i].numpy()
    h, w = s.comp_h[i].numpy(), s.comp_w[i].numpy()
    used = net >= 0
    k = int(s.num_pins[i])
    assert used.sum() == k and used[:k].all()               # a prefix
    assert (np.diff(net[:k]) >= 0).all()                    # net-grouped
    counts = np.bincount(net[:k], minlength=int(s.num_nets[i]))
    assert len(counts) == int(s.num_nets[i])
    assert ((params.min_num_pins_per_net <= counts)
            & (counts <= params.max_num_pins_per_net)).all()
    numc = int(s.num_components[i])
    for j in range(numc):
        mine = comp == j
        cells = set(zip(rx[mine].tolist(), ry[mine].tolist()))
        assert len(cells) == mine.sum() <= h[j] * w[j]
        assert ((rx[mine] >= 0) & (rx[mine] < h[j])).all()
        assert ((ry[mine] >= 0) & (ry[mine] < w[j])).all()
    assert (comp[used] < numc).all() and (comp[~used] == -1).all()


@pytest.mark.parametrize("name,params", [
    ("cap_bound exact", port_params(CAP_BOUND)),
    ("cap_bound fast", port_params(CAP_BOUND).replace(exact_sampling=False)),
    ("parity both", port_params(PARITY["pin"])),
    ("parity spatial exact", port_params(PARITY["pin_spatial"]).replace(
        exact_sampling=True)),
])
def test_reset_invariants(name, params):
    s = core.reset(params, _gen(0), 256, "cpu")
    _assert_instance_invariants(params, s)
    if params.variant == Variant.PIN_SPATIAL:
        # the global creation index: a permutation of 0..num_pins-1
        for i in range(s.batch):
            k = int(s.num_pins[i])
            assert sorted(s.pin_local[i, :k].tolist()) == list(range(k))


# ---------------------------------------------------------------------------
# The capped multinomials against the reference process
# ---------------------------------------------------------------------------

def _port_hist(sampler, seed=1):
    probs = torch.tensor(PROBS, dtype=torch.float32).expand(N_SAMPLES, BINS)
    caps = torch.full((N_SAMPLES, BINS), CAP, dtype=torch.int32)
    trials = torch.full((N_SAMPLES,), TRIALS, dtype=torch.int32)
    out = sampler(_gen(seed), trials, probs.contiguous(), caps, TRIALS)
    assert (out.sum(dim=1) == TRIALS).all() and (out <= CAP).all()
    return _hist(out.numpy())


def test_exact_sampler_matches_reference_process():
    ref = _reference_hist()
    exact = _port_hist(generator._capped_multinomial_exact)
    keys = sorted(set(ref) | set(exact))
    table = np.array([[ref.get(k, 0) + 1 for k in keys],
                      [exact.get(k, 0) + 1 for k in keys]])
    _, p, _, _ = stats.chi2_contingency(table)
    assert p > 1e-3, (p, _tvd(ref, exact, N_SAMPLES))
    assert _tvd(ref, exact, N_SAMPLES) < 0.05


def test_fast_sampler_deviation_is_bounded():
    ref = _reference_hist()
    fast = _port_hist(generator._capped_multinomial)

    def mean(h):
        return sum(np.array(k) * c for k, c in h.items()) / N_SAMPLES

    np.testing.assert_allclose(mean(fast), mean(ref), atol=0.15)
    assert _tvd(ref, fast, N_SAMPLES) < 0.35


def test_all_closed_rows_draw_without_raising():
    """A row whose bins are all closed (an inactive net's) draws bin 0 and
    adds nothing, where ``torch.multinomial`` would raise."""
    logits = torch.full((3, 4), -float("inf"))
    assert generator._categorical(_gen(0), logits, 5).eq(0).all()
    counts = generator._capped_multinomial_exact(
        _gen(0), torch.tensor([2, 2, 0]), torch.zeros((3, 4)),
        torch.zeros((3, 4), dtype=torch.int32), 4)
    assert not counts.any()


def test_per_board_randint_bounds():
    """``_randint`` with per-board bounds (total pins: lo = min_ppn * nets)
    stays in each board's range and reaches both ends."""
    lo = torch.tensor([0, 4, 10, 7])
    hi = torch.tensor([3, 4, 12, 20])
    draws = torch.stack([generator._randint(_gen(s), lo, hi, (4,), "cpu")
                         for s in range(400)])
    assert (draws >= lo).all() and (draws <= hi).all()
    assert torch.equal(draws.min(0).values, lo.int())
    assert torch.equal(draws.max(0).values, hi.int())


def test_exact_sampling_same_distribution_as_compat_pipeline():
    """The per-net pin-count histogram of the port's exact-sampling resets
    on the cap-bound config matches the reference-process (compat)
    pipeline's (test_generator_fidelity.py:116-142)."""
    params = port_params(CAP_BOUND)
    s = core.reset(params, _gen(3), 400, "cpu")
    net = s.pin_net.numpy()
    port = [tuple(sorted(int((net[b] == n).sum())
                         for n in range(int(s.num_nets[b]))))
            for b in range(400)]
    ref = []
    for seed in range(400):
        np.random.seed(10_000 + seed)
        random.seed(10_000 + seed)
        inst = compat.generate_pin_instance(CAP_BOUND)
        nets = [q.net_id for q in inst.pins]
        ref.append(tuple(sorted(nets.count(n)
                                for n in range(inst.num_nets))))
    hp, hr = _hist(port), _hist(ref)
    keys = sorted(set(hp) | set(hr))
    table = np.array([[hp.get(k, 0) + 1 for k in keys],
                      [hr.get(k, 0) + 1 for k in keys]])
    _, p, _, _ = stats.chi2_contingency(table)
    assert p > 1e-3, (p, keys, table)


# ---------------------------------------------------------------------------
# Reset signatures against the JAX reset
# ---------------------------------------------------------------------------

def _signatures(params, comp, net):
    sigs = []
    for b in range(comp.shape[0]):
        pc = tuple(sorted(int((comp[b] == i).sum())
                          for i in range(params.max_components)))
        nc = tuple(int((net[b] == i).sum())
                   for i in range(params.max_num_nets))
        sigs.append(pc + nc)
    return _hist(sigs)


@functools.lru_cache(maxsize=None)
def _jax_reset(jax_params):
    return jax.jit(jax.vmap(lambda k: jax_core.reset(jax_params, k)))


def _jax_signatures(jax_params, seed):
    s = _jax_reset(jax_params)(jax.random.split(jax.random.PRNGKey(seed),
                                                N_RESETS))
    return _signatures(jax_params, np.asarray(s.pin_comp),
                       np.asarray(s.pin_net))


def _signature_configs():
    """The shipped pin configs, and the parity recordings' geometry (2..5
    pins per net: the nets' capped multinomial)."""
    out = {mt: p for p, mt in _shipped_pin_params()}
    out["parity both"] = PARITY["pin"]
    return out


@pytest.mark.parametrize("model_type", list(_signature_configs()))
def test_shipped_configs_match_jax_reset(model_type):
    jp = _signature_configs()[model_type]
    jp = dataclasses.replace(jp, exact_sampling=False)
    want = _jax_signatures(jp, 1)
    noise = _tvd(want, _jax_signatures(jp, 2), N_RESETS)
    for exact in (False, True):
        params = port_params(jp).replace(exact_sampling=exact)
        s = core.reset(params, _gen(4), N_RESETS, "cpu")
        got = _signatures(params, s.pin_comp.numpy(), s.pin_net.numpy())
        dev = _tvd(got, want, N_RESETS)
        assert dev <= noise + 0.03, (model_type, exact, dev, noise)
