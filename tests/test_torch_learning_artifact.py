"""The port's committed H100 learning curves hold JAX's committed bands.

``placement_tpu_torch/experiments/results/`` holds the port's runs of its
learning-curve runners on an NVIDIA H100 (``*_h100*``); the JAX package's
runs of the same runners are in ``experiments/results/``. These tests read
only those CSV and JSON files and hold the port's curves to JAX's with the
tolerances below (fixed before the port's runs were made):

  (a) the flagship spatial curve (``learning_curve --iterations 150``,
      seed 0, 30 epochs): beats the random baseline, lands in the
      5-seed band's final range, wirelength falls, crossings do not rise;
  (a), (b) each port seed at iterations 10, 20, 30 and 40 inside JAX's
      min-max band over its seeds at that iteration and epoch count,
      widened by ``BAND_MARGIN`` on each side;
  (b) the throughput preset's seed sweep (10 epochs, seeds 0-2): every
      final in the flagship band, the seeds' spread small;
  (c) the intersection-weight sweep, at 10 epochs: JAX's invariants
      (``tests/agent/test_learning_artifact.py``), each weight's final
      within ``WEIGHT_FINAL_TOL`` of JAX's 30-epoch final;
  (d) every other preset's curve (``learning_curve --type <preset>
      --iterations 150 --tag _h100``, 30 epochs, or where that did not fit
      ``seed_sweep --type <preset> --seeds 0 --skip-weights --num-sgd-iter
      10 --tag _h100_sgd10``): 150 iterations, the last-10 mean above
      JAX's baseline + margin (``REGISTRY_CURVES``) and within
      ``PRESET_GAP`` x JAX's gain of JAX's own 30-epoch last-10 mean
      (``experiments/results/<preset>_progress.csv``). The presets not run
      on the card yet are ``PENDING``, as ROADMAP Queue 1 item 6 lists
      them.
"""

import csv
import json
import pathlib
import re

import pytest

from placement_tpu_torch.models import MODEL_REGISTRY

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "placement_tpu_torch" / "experiments" / "results"
JAX = REPO / "experiments" / "results"
TYPE = "rectangle_spatial_pin"

#: (a): ``learning_curve --iterations 150`` on the card
FLAGSHIP = PORT / f"{TYPE}_h100_progress.csv"
#: (b): ``seed_sweep --seeds 0 1 2 --num-sgd-iter 10 --skip-weights --tag
#: _h100_sgd10``
SGD10 = PORT / f"{TYPE}_seed_sweep_h100_sgd10.csv"
#: (c): ``reference_comparison --iterations 150 --num-sgd-iter 10 --tag
#: _h100_sgd10`` (the throughput preset's epochs; JAX's sweep ran 30)
WEIGHT_TAG = "_h100_sgd10"
WEIGHTS = PORT / f"{TYPE}_weight_sweep{WEIGHT_TAG}.csv"
CMP_JSON = PORT / f"weight_sweep_reference_comparison{WEIGHT_TAG}.json"

#: JAX's committed seed sweeps: 5 seeds at 30 epochs, 3 at 10
JAX_SEEDS = {30: JAX / f"{TYPE}_seed_sweep.csv",
             10: JAX / f"{TYPE}_seed_sweep_sgd10.csv"}
JAX_WEIGHTS = JAX / f"{TYPE}_weight_sweep.csv"

#: the random-policy mean of the spatial preset, and the flagship band of
#: last-10 means (``tests/agent/test_learning_artifact.py``)
RANDOM_BASELINE = -2.13
BAND_LO, BAND_HI = -1.30, -1.15
#: iterations held to JAX's seed band, and the band's widening
CHECKS = (10, 20, 30, 40)
BAND_MARGIN = 0.10
#: (c): a weight's final against JAX's
WEIGHT_FINAL_TOL = 0.10


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _col(rows, col):
    return [float(r[col]) for r in rows]


def _mean(xs):
    return sum(xs) / len(xs)


def _grouped(path, key):
    groups = {}
    for r in _rows(path):
        groups.setdefault(float(r[key]), []).append(r)
    return groups


def _final(rows):
    return _mean(_col(rows[-10:], "episode_reward_mean"))


def _jax_band(epochs, it):
    ys = [float(rows[it - 1]["episode_reward_mean"])
          for rows in _grouped(JAX_SEEDS[epochs], "seed").values()]
    return min(ys), max(ys)


# --- (a) the flagship curve ------------------------------------------------

def test_flagship_curve_is_committed_whole():
    rows = _rows(FLAGSHIP)
    assert [int(float(r["training_iteration"])) for r in rows] == \
        list(range(1, 151))
    assert (PORT / f"{TYPE}_h100_learning_curve.png").stat().st_size \
        > 10_000


def test_flagship_beats_random_and_lands_in_band():
    final = _final(_rows(FLAGSHIP))
    assert final > RANDOM_BASELINE + 0.5, final
    assert BAND_LO < final < BAND_HI, final


def test_flagship_wirelength_falls():
    ys = _col(_rows(FLAGSHIP), "custom_metrics/normalized_wirelengths_mean")
    assert _mean(ys[-10:]) < _mean(ys[:5]) - 0.5, (ys[:5], ys[-10:])


def test_flagship_intersections_do_not_regress():
    ys = _col(_rows(FLAGSHIP), "custom_metrics/num_intersections_mean")
    assert _mean(ys[-10:]) <= _mean(ys[:10]), (ys[:10], ys[-10:])


def _port_curves():
    """(label, epochs, rewards) of every port seed: (a) and (b)'s."""
    curves = [("flagship", 30,
               _col(_rows(FLAGSHIP), "episode_reward_mean"))]
    for seed, rows in sorted(_grouped(SGD10, "seed").items()):
        curves.append((f"sgd10 seed {int(seed)}", 10,
                       _col(rows, "episode_reward_mean")))
    return curves


@pytest.mark.parametrize("it", CHECKS)
def test_every_port_seed_inside_jax_band(it):
    """(a) against JAX's 5 seeds at 30 epochs, (b)'s seeds against its 3
    at 10, at the same iteration."""
    for label, epochs, ys in _port_curves():
        lo, hi = _jax_band(epochs, it)
        assert lo - BAND_MARGIN <= ys[it - 1] <= hi + BAND_MARGIN, (
            label, it, ys[it - 1], (lo, hi))


# --- (b) the throughput preset's seeds ---------------------------------------

def test_sgd10_seeds_committed_whole():
    groups = _grouped(SGD10, "seed")
    assert sorted(groups) == [0.0, 1.0, 2.0]
    for seed, rows in groups.items():
        assert [int(r["training_iteration"]) for r in rows] == \
            list(range(1, 151)), seed
    assert (PORT / f"{TYPE}_seed_band_h100_sgd10.png").stat().st_size \
        > 10_000


def test_sgd10_every_seed_in_flagship_band():
    finals = {s: _final(rows) for s, rows in _grouped(SGD10, "seed").items()}
    for seed, final in finals.items():
        assert BAND_LO < final < BAND_HI, (seed, final)
        assert final > RANDOM_BASELINE + 0.5, (seed, final)
    assert max(finals.values()) - min(finals.values()) < 0.3, finals


# --- (c) the intersection-weight sweep --------------------------------------

def _by_weight(path):
    return {w: _col(rows, "episode_reward_mean")
            for w, rows in _grouped(path, "weight_num_intersections").items()}


def test_weight_sweep_covers_jax_axis():
    per = _by_weight(WEIGHTS)
    assert set(per) == {0.0, 0.1, 0.5, 0.9}, sorted(per)
    assert all(len(v) == 150 for v in per.values())


@pytest.mark.parametrize("w", (0.0, 0.1, 0.5, 0.9))
def test_weight_final_matches_jax(w):
    port, jax = _by_weight(WEIGHTS)[w], _by_weight(JAX_WEIGHTS)[w]
    got, want = _mean(port[-10:]), _mean(jax[-10:])
    assert abs(got - want) <= WEIGHT_FINAL_TOL, (w, got, want)


def test_weight_sweep_ordering():
    finals = {w: _mean(v[-10:]) for w, v in _by_weight(WEIGHTS).items()}
    ws = sorted(finals)
    for a, b in zip(ws, ws[1:]):
        assert finals[a] > finals[b] + 0.02, (finals, a, b)


def test_weight_sweep_shape():
    for w, v in _by_weight(WEIGHTS).items():
        if w == 0.0:
            continue
        assert -2.7 < v[0] < -1.8, (w, v[0])
        gain_40 = (v[39] - v[0]) / (_mean(v[-10:]) - v[0])
        assert gain_40 > 0.85, (w, gain_40)


def test_alpha_zero_start_is_beta_times_wirelength():
    row = _grouped(WEIGHTS, "weight_num_intersections")[0.0][0]
    start, wl = (float(row["episode_reward_mean"]),
                 float(row["normalized_wirelengths_mean"]))
    assert abs(start - (-0.75 * wl)) < 0.02, (start, wl)


def test_comparison_json_consistent_with_sweep():
    s = json.loads(CMP_JSON.read_text())
    assert s["ordering_matches_reference"] is True
    assert set(s) == set(json.loads(
        (JAX / "weight_sweep_reference_comparison.json").read_text()))
    per = _by_weight(WEIGHTS)
    finals = {float(k): v for k, v in s["final_reward_by_weight"].items()}
    for w, v in per.items():
        assert abs(finals[w] - _mean(v[-10:])) < 0.02, w
    assert CMP_JSON.with_suffix(".png").stat().st_size > 10_000


# --- (d) every other preset --------------------------------------------------

#: JAX's random-policy baseline and margin of each preset
#: (``tests/agent/test_learning_artifact.py::REGISTRY_CURVES``)
REGISTRY_CURVES = {
    "square": (17.6543, 3.0),
    "rectangle": (6.9922, 1.2),
    "rectangle_factorized": (6.9922, 1.2),
    "rectangle_pin": (-1.6536, 0.3),
    "rectangle_pin_attn_component": (-1.6536, 0.3),
    "rectangle_pin_attn_all": (-1.6536, 0.3),
    "rectangle_factorized_pin": (-1.6536, 0.3),
    "rectangle_pin_all_attn_factorized": (-1.6536, 0.3),
    "rectangle_pin_attn_all_no_grid": (-1.6536, 0.3),
}
#: |port final - JAX final| allowed, a share of JAX's gain over its
#: baseline
PRESET_GAP = 0.25
#: presets with no card curve committed yet (ROADMAP Queue 1 item 6)
PENDING = ()


def _run_files(preset, epochs):
    """(table, the runner's summary, its plot) of a card run of a preset:
    ``learning_curve`` at 30 epochs, ``seed_sweep`` at 10."""
    if epochs == 30:
        return (PORT / f"{preset}_h100_progress.csv",
                PORT / f"{preset}_h100_summary.json",
                PORT / f"{preset}_h100_learning_curve.png")
    return (PORT / f"{preset}_seed_sweep_h100_sgd10.csv",
            PORT / f"{preset}_h100_sgd10_summary.json",
            PORT / f"{preset}_seed_band_h100_sgd10.png")


#: every committed card run of a preset other than the spatial flagship:
#: (preset, epochs)
PRESET_RUNS = [(t, e) for t in REGISTRY_CURVES for e in (30, 10)
               if _run_files(t, e)[0].exists()]


@pytest.mark.parametrize("preset,epochs", PRESET_RUNS)
def test_preset_curve_holds_jax(preset, epochs):
    table = _run_files(preset, epochs)[0]
    rows = _rows(table)
    if epochs == 10:
        assert {r["seed"] for r in rows} == {"0"}, table
    assert [int(float(r["training_iteration"])) for r in rows] == \
        list(range(1, 151)), table
    baseline, margin = REGISTRY_CURVES[preset]
    got, want = _final(rows), _final(_rows(JAX / f"{preset}_progress.csv"))
    assert got > baseline + margin, (preset, got, baseline + margin)
    assert abs(got - want) <= PRESET_GAP * abs(want - baseline), (
        preset, got, want, PRESET_GAP * abs(want - baseline))


@pytest.mark.parametrize("preset,epochs", PRESET_RUNS)
def test_preset_summary_and_plot(preset, epochs):
    """The runner's JSON line beside its table: the same final, the card
    and the layout it ran in; the plot drawn from the table."""
    table, summary, png = _run_files(preset, epochs)
    s = json.loads(summary.read_text())
    final = (s["final_reward_mean_last10"] if epochs == 30
             else s["final_reward_by_seed"]["0"])
    assert s["type"] == preset and s["iterations"] == 150
    assert abs(final - _final(_rows(table))) < 1e-3
    assert s["runs_per_card"] >= 1 and "H100" in s["card"]
    assert png.stat().st_size > 10_000


def test_registry_curves_cover_the_registry():
    """Every preset has a committed card curve or is ``PENDING``; the
    pending ones are those ROADMAP Queue 1 item 6 still lists, each with
    its command."""
    assert set(REGISTRY_CURVES) | {TYPE} == set(MODEL_REGISTRY)
    run = {t for t, _ in PRESET_RUNS}
    assert run | set(PENDING) == set(REGISTRY_CURVES)
    assert not run & set(PENDING), run & set(PENDING)
    text = (REPO / "ROADMAP.md").read_text()
    item = text[text.index("\n6. "):text.index("\n7. ")]
    listed = set(re.findall(r"- `(\w+)`: `python -m placement_tpu_torch",
                            item))
    assert listed == set(PENDING), (listed, PENDING)
