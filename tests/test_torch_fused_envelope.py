"""The port's fused kernels take every configuration the JAX kernel takes.

The JAX kernel's envelope (``placement_tpu/ops/fused_rollout.py``
``envelope_report``) limits the area (144), the footprints, the components,
the pins (48), the pins per component and the beam width; it has no limit of
its own on nets, pins per net, height or width. The port's kernels have a
general instantiation beside the one for the flagship's sizes: up to 24 nets
and 48 pins per net (the pin tables), and a board as a row-major bit string
over the warp's lanes, so one side may pass 32 where the area stays within
144.

  * the sweep: wherever JAX's ``envelope_report(params, block=8)`` accepts a
    configuration of a grid over its static limits, the port's ``supports``
    does too; both refuse the over-limit cases; JAX refuses the web app's
    maximum, which the port takes on the centroid kernel's wide
    instantiation (and refuses under the beam and "both" rewards);
  * the edge configurations (``EDGES``): the port's plain version against
    the JAX kernel under the Pallas TPU interpreter, 16 all-done zero
    boards, logical block 8, two chained chunks, through recorded fixtures
    (``fixtures/torch_fused_zero_envelope_<name>.json``: the JAX kernel's
    final leaf hashes and totals, which ``chip_smoke.py`` also holds the
    CUDA kernel to) and, for two of them, live;
  * ``bench_matrix.measure`` runs such a configuration on the fused engine,
    as the JAX tool's does.

The JAX interpreter takes about a minute to compile each pin configuration
but ``nets24_both``, whose compile XLA's fusion passes take past 30 GB;
without them it compiles in ~10 minutes and 2 GB, to the same results.
Re-record the fixtures (all, or those named) with
``XLA_FLAGS=--xla_disable_hlo_passes=fusion PYTHONPATH=. python
tests/test_torch_fused_envelope.py [name ...]``.
"""

import dataclasses
import itertools
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
#: per-block sums (test_torch_fused_varpin.RSUM_TOL)
RSUM_TOL = 2e-3
BATCH, STEPS, BLOCK, SEEDS = 16, 20, 8, (1234, 1235)
#: the block at which JAX's envelope is read: its VMEM estimate grows with
#: the block and at 8 never binds inside the static limits
JAX_BLOCK = 8

#: 8 components of 2..3 x 3 on a 12 x 12 board: room for 48 pins
_ROOMY = {"height": 12, "width": 12, "min_component_h": 2,
          "max_component_h": 3, "min_component_w": 3, "max_component_w": 3,
          "min_num_components": 8, "max_num_components": 8}

#: name -> (config, overrides): every one passes JAX's envelope at block 8
#: and the flagship-sized kernels' capacities refuse it
EDGES = {
    # the web app's Train page: the flagship with 10 nets of 2..4 pins
    "web_nets10": ("rectangle_pin", {
        "min_num_nets": 10, "max_num_nets": 10, "min_num_pins_per_net": 2,
        "max_num_pins_per_net": 4}),
    "nets24_both": ("rectangle_pin", {
        **_ROOMY, "min_num_nets": 24, "max_num_nets": 24,
        "min_num_pins_per_net": 2, "max_num_pins_per_net": 2,
        "reward_type": "both"}),
    "ppn24_beam4": ("rectangle_pin", {
        **_ROOMY, "min_num_nets": 2, "max_num_nets": 2,
        "min_num_pins_per_net": 24, "max_num_pins_per_net": 24,
        "reward_type": "beam", "reward_beam_width": 4}),
    "ppn48_beam2": ("rectangle_pin", {
        **_ROOMY, "min_num_nets": 1, "max_num_nets": 1,
        "min_num_pins_per_net": 48, "max_num_pins_per_net": 48,
        "reward_type": "beam", "reward_beam_width": 2}),
    "wide_rect": ("rectangle", {
        "height": 4, "width": 36, "min_component_h": 1, "max_component_h": 2,
        "min_component_w": 1, "max_component_w": 3, "min_num_components": 10,
        "max_num_components": 20}),
    "tall_square": ("square", {"height": 36, "width": 4}),
    # its mirror: rows over 32 cells, a row two whole words
    "wide_square": ("square", {"height": 4, "width": 36}),
    "wide_pin": ("rectangle_pin", {"height": 3, "width": 48}),
    # the Train page's most nets with the beam route: "both", width 2
    "web_nets10_both": ("rectangle_pin", {
        "min_num_nets": 10, "max_num_nets": 10, "min_num_pins_per_net": 2,
        "max_num_pins_per_net": 4, "reward_type": "both",
        "reward_beam_width": 2}),
}
#: the edges whose JAX run is repeated live (the others read the fixture)
LIVE = ("web_nets10", "wide_rect")


def golden_path(name):
    return FIXTURES / f"torch_fused_zero_envelope_{name}.json"


def _params(config, overrides):
    return (dataclasses.replace(load_experiment(config)[0], **overrides),
            load_env_params(config).replace(**overrides))


def _zero(t_params):
    return torch_fused.leaves_to_numpy(
        torch_fused.zero_leaves(t_params, BATCH, "cpu"))


def _jax_chain(name):
    """The JAX kernel's chunk per seed, chained -> [(leaves, rsum, dcnt)]."""
    params, t_params = _params(*EDGES[name])
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
    _, t_params = _params(*EDGES[name])
    fn = torch_fused.make_fused_rollout(t_params, BATCH, STEPS, block=BLOCK,
                                        device="cpu")
    assert fn.tier == "general"
    leaves = torch_fused.leaves_from_numpy(_zero(t_params), "cpu")
    runs = []
    for seed in SEEDS:
        leaves, rsum, dcnt = fn(leaves, seed)
        runs.append((torch_fused.leaves_to_numpy(leaves), float(rsum),
                     int(dcnt)))
    assert fn.launches == 0   # CPU tensors take the plain version
    return runs


def zero_golden(name, runs):
    from tests.test_torch_fused_varpin import leaf_sha256
    config, overrides = EDGES[name]
    leaves = runs[-1][0]
    return {"config": config, "overrides": overrides, "batch": BATCH,
            "num_steps": STEPS, "seeds": list(SEEDS), "block": BLOCK,
            "reward_sum": sum(r[1] for r in runs),
            "done_count": sum(r[2] for r in runs),
            "sha256": {k: leaf_sha256(leaves[k])
                       for k in torch_fused._LEAVES}}


# ---------------------------------------------------------------------------
# The sweep over JAX's static limits
# ---------------------------------------------------------------------------

BOARDS = ((10, 10), (12, 12), (4, 36), (36, 4), (3, 48), (2, 72), (32, 32))


def _pin_grid():
    """(nets, min ppn, max ppn): nets 1-24, pins per net 2-48 fixed and
    varying, up to a few pins past 48."""
    for nets in range(1, 25):
        for hi in range(2, 49):
            if nets * hi > 56:
                break
            yield nets, hi, hi
            if hi > 2:
                yield nets, 2, hi


def _sweep(config, reward):
    """Every valid configuration of the grid for ``config`` (and
    ``reward``) as (label, JAX params, port params)."""
    base_j = load_experiment(config)[0]
    base_t = load_env_params(config)
    for (h, w) in BOARDS:
        # footprints of up to 3 x 3 (16 pins a component at most)
        ch, cw = min(h, 3), min(w, 3)
        if config == "square":
            grids = [{"component_n": n} for n in range(1, min(h, w) + 1)]
        elif config == "rectangle":
            grids = [{"min_num_components": c, "max_num_components": c,
                      "min_component_h": h0, "max_component_h": h1,
                      "min_component_w": w0, "max_component_w": w1}
                     for c in (1, 4, 8, 16, 20, 32, 40, 64, 65)
                     for (h0, h1) in ((1, 1), (1, ch), (ch, ch))
                     for (w0, w1) in ((1, 1), (1, cw), (cw, cw))]
        else:
            grids = [{"min_num_components": c, "max_num_components": c,
                      "min_component_h": ch, "max_component_h": ch,
                      "min_component_w": cw, "max_component_w": cw,
                      "min_num_nets": n, "max_num_nets": n,
                      "min_num_pins_per_net": lo,
                      "max_num_pins_per_net": hi, "reward_type": reward,
                      "reward_beam_width": bw}
                     for c in range(1, 10)
                     for (n, lo, hi) in _pin_grid()
                     for bw in ((2, 4, 5) if reward != "centroid" else (2,))]
        for ov in grids:
            ov = {"height": h, "width": w, **ov}
            t = base_t.replace(**ov)
            try:
                t.validate()
            except ValueError:
                continue
            yield ov, dataclasses.replace(base_j, **ov), t


@pytest.mark.parametrize("config,reward", [
    *itertools.product(("rectangle_pin", "rectangle_spatial_pin"),
                       ("centroid", "beam", "both")),
    ("rectangle", None), ("square", None)])
def test_port_fuses_every_config_jax_fuses(config, reward):
    accepted = missed = 0
    misses = []
    for ov, j, t in _sweep(config, reward):
        if not jax_fused.envelope_report(j, block=JAX_BLOCK)[0]:
            continue
        accepted += 1
        if not torch_fused.supports(t):
            missed += 1
            misses.append((ov, torch_fused.envelope_report(t)[1]))
    assert accepted > 20
    assert not missed, (f"{missed} of {accepted} configurations JAX fuses "
                        f"are refused, e.g. {misses[:3]}")


#: the web app's maximum sliders: JAX refuses them, the port takes them
#: on the wide instantiation of the centroid kernel and refuses them under
#: the beam and "both" rewards
WEB_MAX = {"height": 30, "width": 30,
           "min_component_h": 1, "max_component_h": 5,
           "min_component_w": 1, "max_component_w": 5,
           "min_num_components": 10, "max_num_components": 40,
           "min_num_nets": 2, "max_num_nets": 10,
           "min_num_pins_per_net": 2, "max_num_pins_per_net": 10}
#: past the general instantiation's pin tables, within the wide one's
_NINE_COMPONENTS = {"max_num_components": 9, "min_num_components": 9}
_PPC20 = {"min_component_h": 2, "max_component_h": 5, "min_component_w": 2,
          "max_component_w": 4}
#: 40 components of 2..5 x 2..5 on a 32 x 32 board (room for 129 pins)
_MANY = {"height": 32, "width": 32, "min_component_h": 2,
         "max_component_h": 5, "min_component_w": 2, "max_component_w": 5,
         "min_num_components": 40, "max_num_components": 40}


@pytest.mark.parametrize("config,overrides,limit", [
    # the beam and "both" rewards have no wide instantiation: a pin config
    # past the general one's tables is refused under its named limit
    ("rectangle_pin", {**WEB_MAX, "reward_type": "beam"}, "pins=100 > 48"),
    ("rectangle_pin", {"height": 10, "width": 33}, "area=330 > 144"),
    ("rectangle_pin", {"height": 5, "width": 40}, "area=200 > 144"),
    ("rectangle_pin", {**_NINE_COMPONENTS, "reward_type": "both"},
     "components=9 > 8"),
    ("rectangle_pin", {"min_num_nets": 2, "max_num_nets": 25,
                       "min_num_pins_per_net": 2,
                       "max_num_pins_per_net": 2, "reward_type": "beam"},
     "pins=50 > 48"),
    ("rectangle_pin", {**_PPC20, "reward_type": "beam"},
     "pins_per_component=20 > 16"),
    ("rectangle_pin", {"reward_type": "beam", "reward_beam_width": 5},
     "beam_width=5 > 4"),
    ("rectangle", {"min_num_components": 65, "max_num_components": 65,
                   "height": 12, "width": 12, "min_component_h": 1,
                   "max_component_h": 1, "min_component_w": 1,
                   "max_component_w": 1}, "components_nopin=65 > 64"),
    ("square", {"height": 3, "width": 49}, "area=147 > 144"),
    # the centroid reward's wide instantiation, at its own limits
    ("rectangle_pin", {"height": 32, "width": 32, "min_component_h": 1,
                       "max_component_h": 2, "min_component_w": 1,
                       "max_component_w": 2, "min_num_components": 65,
                       "max_num_components": 65}, "components=65 > 64"),
    ("rectangle_pin", {**_MANY, "min_num_nets": 3, "max_num_nets": 3,
                       "min_num_pins_per_net": 43,
                       "max_num_pins_per_net": 43}, "pins=129 > 128"),
    ("rectangle_pin", {"height": 32, "width": 32, "min_component_h": 2,
                       "max_component_h": 6, "min_component_w": 2,
                       "max_component_w": 6}, "pins_per_component=36 > 25"),
    ("rectangle_pin", {**_MANY, "min_num_nets": 2, "max_num_nets": 25,
                       "min_num_pins_per_net": 2,
                       "max_num_pins_per_net": 2}, "nets=25 > 24"),
])
def test_both_refuse_over_limit_configs(config, overrides, limit):
    j, t = _params(config, overrides)
    assert not jax_fused.envelope_report(j, block=JAX_BLOCK)[0]
    ok, reasons = torch_fused.envelope_report(t)
    assert not ok and limit in reasons, reasons
    with pytest.raises(ValueError, match="envelope"):
        torch_fused.make_fused_rollout(t, 8, 5, device="cpu")


@pytest.mark.parametrize("config,overrides", [
    ("rectangle_pin", WEB_MAX),
    ("rectangle_spatial_pin", WEB_MAX),
    ("rectangle_pin", _NINE_COMPONENTS),
    ("rectangle_pin", _PPC20),
    ("rectangle_pin", {"min_num_nets": 2, "max_num_nets": 24,
                       "min_num_pins_per_net": 2, "max_num_pins_per_net": 2,
                       **_MANY}),
], ids=["web_max", "web_max_spatial", "components9", "ppc20", "pins48_40c"])
def test_jax_refuses_what_the_wide_tier_takes(config, overrides):
    """Centroid pin configs past the JAX kernel's envelope (and the general
    instantiation's tables) on sides of up to 32: the port takes them on
    the wide instantiation."""
    j, t = _params(config, {**overrides, "reward_type": "centroid"})
    assert not jax_fused.envelope_report(j, block=JAX_BLOCK)[0]
    assert torch_fused.envelope_report(t) == (True, [])
    assert torch_fused.kernel_tier(t) == "wide"
    assert torch_fused.needs_wide(t) and not torch_fused.needs_general(t)
    fn = torch_fused.make_fused_rollout(t, 8, 5, device="cpu")
    assert fn.tier == "wide" and fn._kparams.tier == 2


@pytest.mark.parametrize("name", sorted(EDGES))
def test_edge_config_is_general_and_only_jax_would_take_it_before(name):
    """Each edge passes JAX's envelope and needs the general
    instantiation: a capacity of the flagship-sized one refuses it."""
    j, t = _params(*EDGES[name])
    assert jax_fused.envelope_report(j, block=JAX_BLOCK) == (True, [])
    assert torch_fused.supports(t) and torch_fused.needs_general(t)


# ---------------------------------------------------------------------------
# The plain version against the JAX kernel on the edges
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_chains():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _port_chain(name)
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(EDGES))
def test_plain_version_matches_recorded_jax_kernel(name, port_chains):
    stored = json.loads(golden_path(name).read_text())
    assert (stored["config"], stored["overrides"]) == EDGES[name]
    got = zero_golden(name, port_chains(name))
    assert abs(got.pop("reward_sum") - stored.pop("reward_sum")) <= RSUM_TOL
    bad = [k for k in torch_fused._LEAVES
           if got["sha256"][k] != stored["sha256"][k]]
    assert not bad, f"leaves differ from the JAX kernel's: {bad}"
    assert got == stored
    assert got["done_count"] >= BATCH      # the zero boards, at least


@pytest.mark.parametrize("name", LIVE)
def test_plain_version_matches_live_jax_kernel(name, port_chains):
    """The interpreter itself on two edges: leaves and done counts equal,
    reward sums within RSUM_TOL, and the fixture fresh."""
    jax_runs = _jax_chain(name)
    for (want, want_r, want_d), (got, got_r, got_d) in zip(
            jax_runs, port_chains(name)):
        for k in torch_fused._LEAVES:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got_d == want_d
        assert abs(got_r - want_r) <= RSUM_TOL, (got_r, want_r)
    stored = json.loads(golden_path(name).read_text())
    fresh = zero_golden(name, jax_runs)
    assert abs(stored.pop("reward_sum") - fresh.pop("reward_sum")) <= RSUM_TOL
    assert stored == fresh


def test_bench_matrix_measures_web_nets10_on_the_fused_engine():
    """The matrix tool runs the web app's 10-net config on the fused engine
    (the plain version on the CPU), as the JAX tool picks its fused one."""
    from placement_tpu_torch.tools import bench_matrix
    j, t = _params(*EDGES["web_nets10"])
    assert jax_fused.supports(j)
    row, leaves = bench_matrix.measure("web_nets10", t, "web app", 16,
                                       device="cpu", inner=4, block=8)
    assert row["engine"] == "fused_plain" and row["kernel"] == "centroid"
    assert row["launches"] == 0 and row["episodes"] >= 16
    assert np.isfinite(row["reward_sum"])
    counts = np.stack([(leaves["pin_net"].numpy() == n).sum(1)
                       for n in range(t.max_num_nets)], 1)
    assert ((counts == 0) | ((counts >= 2) & (counts <= 4))).all()


if __name__ == "__main__":
    import sys
    FIXTURES.mkdir(parents=True, exist_ok=True)
    for n in sys.argv[1:] or EDGES:
        golden_path(n).write_text(
            json.dumps(zero_golden(n, _jax_chain(n)), indent=1,
                       sort_keys=True) + "\n")
        print(f"wrote {golden_path(n)}", flush=True)
