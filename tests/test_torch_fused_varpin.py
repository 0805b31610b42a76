"""The port's varying-pins-per-net generator against the JAX kernel.

With ``max_num_pins_per_net > min_num_pins_per_net`` the JAX kernel's
generator spreads the extra pins over the nets (``fused_rollout.py``
:407-450): softmax-normal weights from ``log``, ``cos``, ``exp`` and
``sqrt``, a capped multinomial, an in-order water-fill. The port evaluates
those four in f64 and rounds to f32 (``fused_routing._f64_rounded``);
XLA's f32 versions are not correctly rounded, so a board could differ only
where a uniform draw lies within an ulp of a cumulative weight. The leaves
below are equal.

Two configs, each 128 all-done zero boards, 25 steps, block 128, seeds
1234 then 1235 chained, the JAX kernel under the Pallas TPU interpreter
(one compile per config, shared through a module-scoped fixture):

  * ``web`` — the web app's Train-page default: the flagship
    ``rectangle_pin`` config with 2..6 pins per net, centroid reward;
  * ``parity`` — the geometry of ``tools/record_reference.py:114-121``
    (3..6 components of 1..3 x 2..3, 2..4 nets of 2..5 pins,
    ``net_distribution=2``, ``pin_spread=2``) with the "both" reward.

Fixtures ``fixtures/torch_fused_zero_b128_varpin_{web,parity}.json`` hold
the JAX kernel's final leaf hashes and totals for ``chip_smoke.py``;
re-record them with ``PYTHONPATH=. python tests/test_torch_fused_varpin.py``.
"""

import dataclasses
import hashlib
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from placement_tpu.ops import fused_rollout as jax_fused
from placement_tpu.utils.config import load_experiment
from placement_tpu_torch.ops import fused_rollout as torch_fused
from placement_tpu_torch.utils.config import load_env_params

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"

#: boards' reward sums are summed in another order than the JAX kernel's
#: per-block sums (test_torch_fused_rollout.RSUM_TOL)
RSUM_TOL = 2e-3
BATCH, STEPS, BLOCK, SEEDS = 128, 25, 128, (1234, 1235)

#: name -> (config, overrides)
CONFIGS = {
    "web": ("rectangle_pin", {"min_num_pins_per_net": 2}),
    "parity": ("rectangle_pin", {
        "height": 10, "width": 10, "net_distribution": 2, "pin_spread": 2,
        "min_component_w": 2, "max_component_w": 3,
        "min_component_h": 1, "max_component_h": 3,
        "max_num_components": 6, "min_num_components": 3,
        "min_num_nets": 2, "max_num_nets": 4,
        "max_num_pins_per_net": 5, "min_num_pins_per_net": 2,
        "reward_beam_width": 2, "weight_wirelength": 0.5,
        "weight_num_intersections": 0.5, "reward_type": "both"}),
}


def golden_path(name):
    return FIXTURES / f"torch_fused_zero_b128_varpin_{name}.json"


def _params(name):
    config, overrides = CONFIGS[name]
    return (dataclasses.replace(load_experiment(config)[0], **overrides),
            load_env_params(config).replace(**overrides))


def _zero(t_params):
    return torch_fused.leaves_to_numpy(
        torch_fused.zero_leaves(t_params, BATCH, "cpu"))


def _jax_chain(name):
    """The JAX kernel's chunk per seed, chained -> [(leaves, rsum, dcnt)]."""
    params, t_params = _params(name)
    fn = jax_fused.make_fused_rollout(params, BATCH, STEPS, block=BLOCK,
                                      interpret=True)
    leaves = {k: jnp.asarray(v) for k, v in _zero(t_params).items()}
    runs = []
    for seed in SEEDS:
        leaves, rsum, dcnt = fn(leaves, seed)
        runs.append(({k: np.asarray(v) for k, v in leaves.items()},
                     float(rsum), int(dcnt)))
    return runs


def _port_chain(name):
    _, t_params = _params(name)
    fn = torch_fused.make_fused_rollout(t_params, BATCH, STEPS, block=BLOCK,
                                        device="cpu")
    leaves = torch_fused.leaves_from_numpy(_zero(t_params), "cpu")
    runs = []
    for seed in SEEDS:
        leaves, rsum, dcnt = fn(leaves, seed)
        runs.append((torch_fused.leaves_to_numpy(leaves), float(rsum),
                     int(dcnt)))
    assert fn.launches == 0   # CPU tensors take the plain version
    return runs


def leaf_sha256(arr: np.ndarray) -> str:
    """sha256 of a leaf's little-endian bytes (f32 or i32)."""
    kind = "<f4" if arr.dtype.kind == "f" else "<i4"
    return hashlib.sha256(np.ascontiguousarray(arr, kind).tobytes()
                          ).hexdigest()


def zero_golden(name, runs):
    config, overrides = CONFIGS[name]
    leaves = runs[-1][0]
    return {"config": config, "overrides": overrides, "batch": BATCH,
            "num_steps": STEPS, "seeds": list(SEEDS), "block": BLOCK,
            "reward_sum": sum(r[1] for r in runs),
            "done_count": sum(r[2] for r in runs),
            "sha256": {k: leaf_sha256(leaves[k])
                       for k in torch_fused._LEAVES}}


@pytest.fixture(scope="module")
def chains():
    """name -> (JAX runs, port runs), each computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (_jax_chain(name), _port_chain(name))
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_varpin_chunks_match_jax_kernel(name, chains):
    jax_runs, port_runs = chains(name)
    for (want, want_r, want_d), (got, got_r, got_d) in zip(jax_runs,
                                                           port_runs):
        for k in torch_fused._LEAVES:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got_d == want_d > BATCH
        assert abs(got_r - want_r) <= RSUM_TOL, (got_r, want_r)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_varpin_net_counts_are_in_range(name, chains):
    """Every board's nets are a prefix 0..k-1, each with min_ppn..max_ppn
    pins, net-grouped in table order, summing to num_pins; some nets carry
    extra pins and the pin count varies between boards."""
    _, t_params = _params(name)
    lo, hi = t_params.min_num_pins_per_net, t_params.max_num_pins_per_net
    for leaves, _, _ in chains(name)[1]:
        pnet, npin = leaves["pin_net"], leaves["num_pins"][:, 0]
        counts = np.stack([(pnet == n).sum(1)
                           for n in range(t_params.max_num_nets)], 1)
        nets = (counts > 0).sum(1)
        assert (counts.sum(1) == npin).all()
        for b in range(BATCH):
            assert (counts[b, :nets[b]] >= lo).all()
            assert (counts[b, :nets[b]] <= hi).all()
            assert (pnet[b, :npin[b]] == np.repeat(
                np.arange(nets[b]), counts[b, :nets[b]])).all()
            assert (pnet[b, npin[b]:] == -1).all()
        assert (counts > lo).any() and len(set(npin)) > 3


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_chip_bound_counts_the_crossing_tests_made(name, chains):
    """``chip_smoke._route_pairs`` counts, per board, the segment pairs the
    routing rewards test for a crossing, as the kernels' loops do: the
    centroid route's valid segments (one for a 2-pin net, its first pin's)
    on different nets, and the beam route's ``min(count, M) - 1`` segments
    per net, on different nets."""
    import chip_smoke
    _, t_params = _params(name)
    N, M = t_params.max_num_nets, t_params.max_num_pins_per_net
    leaves = chains(name)[1][-1][0]
    pins = centroid = beam = 0
    for b in range(BATCH):
        net = leaves["pin_net"][b, :leaves["num_pins"][b, 0]].tolist()
        cnt = [net.count(n) for n in range(N)]
        start = np.cumsum([0] + cnt)
        valid = [cnt[n] != 2 or q == start[n] for q, n in enumerate(net)]
        centroid += sum(valid[q] and valid[r] and net[q] != net[r]
                        for q in range(len(net))
                        for r in range(q + 1, len(net)))
        seg = [max(min(c, M) - 1, 0) for c in cnt]
        beam += sum(seg[i] * seg[j] for i in range(N)
                    for j in range(i + 1, N))
        pins += len(net)
    got = chip_smoke._route_pairs(
        t_params, torch_fused.leaves_from_numpy(leaves, "cpu"))
    assert got == pytest.approx((pins / BATCH, centroid / BATCH,
                                 beam / BATCH))
    assert got[1] < got[0] * (got[0] - 1) / 2     # not every pin pair


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_varpin_fixtures_are_fresh(name, chains):
    """The committed goldens equal what the JAX package records now."""
    stored = json.loads(golden_path(name).read_text())
    fresh = zero_golden(name, chains(name)[0])
    # the leaves' bytes are exact; the f32 reward sum may move by summation
    # order between machines
    assert abs(stored.pop("reward_sum") - fresh.pop("reward_sum")) <= RSUM_TOL
    assert stored == fresh


@pytest.mark.parametrize("variant", ["rectangle_pin", "rectangle_spatial_pin"])
@pytest.mark.parametrize("reward", ["centroid", "beam", "both"])
def test_varpin_is_supported_for_every_reward(variant, reward):
    """make_fused_rollout takes PIN / PIN_SPATIAL with max_ppn > min_ppn for
    every reward type, as the JAX supports() does; the reward picks the
    kernel and pins per net stay in range."""
    overrides = {"min_num_pins_per_net": 2, "max_num_pins_per_net": 5,
                 "reward_type": reward}
    params = load_env_params(variant).replace(**overrides)
    assert torch_fused.supports(params)
    assert jax_fused.supports(dataclasses.replace(
        load_experiment(variant)[0], **overrides))
    fn = torch_fused.make_fused_rollout(params, 8, 6, block=8,
                                        device="cpu")
    assert fn.kernel == reward
    out, _, dcnt = fn(torch_fused.zero_leaves(params, 8, "cpu"), 1)
    assert int(dcnt) >= 8 and fn.launches == 0
    counts = np.stack([(out["pin_net"].numpy() == n).sum(1)
                       for n in range(params.max_num_nets)], 1)
    assert ((counts == 0) | ((counts >= 2) & (counts <= 5))).all()


if __name__ == "__main__":
    FIXTURES.mkdir(parents=True, exist_ok=True)
    for n in CONFIGS:
        golden_path(n).write_text(
            json.dumps(zero_golden(n, _jax_chain(n)), indent=1,
                       sort_keys=True) + "\n")
        print(f"wrote {golden_path(n)}")
