"""The port's fused rollout against the JAX Pallas kernel.

The JAX kernel runs here as its own tests run it on the CPU: under the
Pallas TPU interpreter (``make_fused_rollout(..., interpret=True)``). The
port's plain PyTorch version (``rollout_chunk_reference``, which
``make_fused_rollout`` runs for CPU tensors) must reproduce it exactly on
every leaf: the counter-hash PRNG, the draw order, the sorts and the f32
sampling arithmetic are the same. Only the f32 reward sum may differ, by the
order in which wirelength terms and boards are summed.

Two fixtures, recorded from the JAX package, let ``chip_smoke.py`` hold the
CUDA kernel to the same numbers on a machine without JAX:

  * ``fixtures/torch_fused_init_k7_b128.npz`` — ``init_leaves(PRNGKey(7),
    128)``, the start state of the TPU hardware goldens;
  * ``fixtures/torch_fused_zero_b128.json`` — per-leaf sha256 (little-endian
    bytes), reward sum and done count of the JAX kernel on 128 zero boards,
    26 steps, seed 1234, block 128.

Re-record them with ``python tests/test_torch_fused_rollout.py`` (the
freshness test below fails when they go stale).
"""

import hashlib
import json
import pathlib
import pkgutil
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import placement_tpu_torch
from placement_tpu.ops import fused_rollout as jax_fused
from placement_tpu.utils.config import load_experiment
from placement_tpu_torch.ops import _build
from placement_tpu_torch.ops import fused_rollout as torch_fused
from placement_tpu_torch.utils.config import load_env_params

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
INIT_K7 = FIXTURES / "torch_fused_init_k7_b128.npz"
ZERO_B128 = FIXTURES / "torch_fused_zero_b128.json"
HW_GOLDENS = REPO / "experiments" / "results" / "fused_hw_validation.json"

#: boards' reward sums are summed in another order than the JAX kernel's
#: per-block sums, and each board's wirelength terms in another lane order:
#: a few f32 ulps of ~1e3 per 128 boards (ulp(1024) = 1.2e-4)
RSUM_TOL = 2e-3


def _jax_run(name, leaves, seed, steps, block):
    """The JAX Pallas kernel under the TPU interpreter -> numpy."""
    params, _, _ = load_experiment(name)
    batch = leaves["grid"].shape[0]
    fn = jax_fused.make_fused_rollout(params, batch, steps, block=block,
                                      interpret=True)
    out, rsum, dcnt = fn({k: jnp.asarray(v) for k, v in leaves.items()},
                         seed)
    return ({k: np.asarray(v) for k, v in out.items()}, float(rsum),
            int(dcnt))


def _port_run(name, leaves, seed, steps, block):
    params = load_env_params(name)
    batch = leaves["grid"].shape[0]
    fn = torch_fused.make_fused_rollout(params, batch, steps, block=block,
                                        device="cpu")
    out, rsum, dcnt = fn(torch_fused.leaves_from_numpy(leaves, "cpu"), seed)
    assert fn.launches == 0   # CPU tensors take the plain version
    return torch_fused.leaves_to_numpy(out), float(rsum), int(dcnt)


def _zero(name, batch):
    return torch_fused.leaves_to_numpy(
        torch_fused.zero_leaves(load_env_params(name), batch, "cpu"))


def _assert_leaves_equal(got, want):
    assert set(got) == set(want) == set(torch_fused._LEAVES)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def leaf_sha256(arr: np.ndarray) -> str:
    """sha256 of a leaf's little-endian bytes (f32 or i32)."""
    kind = "<f4" if arr.dtype.kind == "f" else "<i4"
    return hashlib.sha256(np.ascontiguousarray(arr, kind).tobytes()
                          ).hexdigest()


def k7_leaves():
    """The hardware goldens' start state, from the JAX package."""
    params, _, _ = load_experiment("rectangle_pin")
    leaves = jax_fused.init_leaves(params, jax.random.PRNGKey(7), 128)
    return {k: np.asarray(v) for k, v in leaves.items()}


def zero_golden(out, rsum, dcnt):
    return {"config": "rectangle_pin", "batch": 128, "num_steps": 26,
            "seed": 1234, "block": 128, "reward_sum": rsum,
            "done_count": dcnt,
            "sha256": {k: leaf_sha256(out[k]) for k in torch_fused._LEAVES}}


@pytest.fixture(scope="module")
def jax_zero_b128():
    return _jax_run("rectangle_pin", _zero("rectangle_pin", 128), 1234, 26,
                    128)


# ---------------------------------------------------------------------------
# PRNG bit stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("salt", [0, 1, 1234, 0x9e3779b9, 0xFFFFFFFF])
def test_mix_and_bits_match_jax(salt):
    xs = np.random.default_rng(salt % 97).integers(0, 2**32, 257,
                                                   dtype=np.uint64)
    want = np.asarray(jax_fused._mix(jnp.asarray(xs, jnp.uint32)))
    got = torch_fused._mix(torch.from_numpy(xs.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))

    j_rng = jax_fused._Rng(jnp.uint32(salt))
    rows = 37
    t_rng = torch_fused._Rng(torch.tensor(salt, dtype=torch.int64),
                             torch.arange(rows).view(rows, 1))
    for width in (1, 5, 6, 20, 1):   # successive calls advance the counter
        want = np.asarray(j_rng.bits((rows, width))).astype(np.int64)
        np.testing.assert_array_equal(t_rng.bits(width).numpy(), want)


# ---------------------------------------------------------------------------
# The plain version against the JAX kernel
# ---------------------------------------------------------------------------

def test_zero_start_matches_jax_kernel(jax_zero_b128):
    want, want_r, want_d = jax_zero_b128
    got, got_r, got_d = _port_run("rectangle_pin",
                                  _zero("rectangle_pin", 128), 1234, 26, 128)
    _assert_leaves_equal(got, want)
    assert got_d == want_d == 768   # 1 + 5 episodes per board
    assert abs(got_r - want_r) <= RSUM_TOL, (got_r, want_r)


def test_zero_leaves_are_bench_dummy_states():
    """zero_leaves == leaves_from_states of bench.py's all-done zero
    states, built without compiling the generator."""
    from placement_tpu.env import core
    params, _, _ = load_experiment("rectangle_pin")
    shapes = jax.eval_shape(lambda k: core.reset(params, k),
                            jax.random.PRNGKey(0))
    states = jax.tree_util.tree_map(
        lambda s: jnp.zeros((8,) + s.shape, s.dtype), shapes)
    want = {k: np.asarray(v)
            for k, v in jax_fused.leaves_from_states(params, states).items()}
    _assert_leaves_equal(_zero("rectangle_pin", 8), want)


def test_mid_episode_matches_jax_kernel():
    """From a JAX reset state, 7 steps: pin rotation and a mid-episode
    stop (cursor 2, 8 occupied cells), as test_fused_rollout.py:91-108."""
    params, _, _ = load_experiment("rectangle_pin")
    start = {k: np.asarray(v) for k, v in jax_fused.init_leaves(
        params, jax.random.PRNGKey(5), 16).items()}
    want, want_r, want_d = _jax_run("rectangle_pin", start, 77, 7, 16)
    got, got_r, got_d = _port_run("rectangle_pin", start, 77, 7, 16)
    _assert_leaves_equal(got, want)
    assert got_d == want_d == 16
    assert (got["cursor"] == 2).all()
    assert (got["grid"].sum(axis=1) == 8).all()
    assert abs(got_r - want_r) <= RSUM_TOL


def test_spatial_zero_start_matches_jax_kernel():
    name = "rectangle_spatial_pin"
    want, want_r, want_d = _jax_run(name, _zero(name, 32), 1234, 26, 32)
    got, got_r, got_d = _port_run(name, _zero(name, 32), 1234, 26, 32)
    _assert_leaves_equal(got, want)
    assert got_d == want_d == 32 * 6
    assert abs(got_r - want_r) <= RSUM_TOL


def test_port_reproduces_hardware_golden():
    """The TPU-measured centroid row of fused_hw_validation.json (k7 start,
    128 boards, 25 steps, seed 1234, block 128); the artifact rounds to 3
    decimals, hence 2e-3."""
    hw = json.loads(HW_GOLDENS.read_text())["centroid"]
    start = dict(np.load(INIT_K7))
    _, rsum, dcnt = _port_run("rectangle_pin", start, 1234, 25, 128)
    assert dcnt == hw["episodes"] == 640
    assert abs(rsum - hw["reward_sum"]) <= 2e-3, (rsum, hw["reward_sum"])


def test_fixtures_are_fresh(jax_zero_b128):
    """The committed fixtures equal what the JAX package records now."""
    stored = dict(np.load(INIT_K7))
    _assert_leaves_equal(stored, k7_leaves())
    stored = json.loads(ZERO_B128.read_text())
    fresh = zero_golden(*jax_zero_b128)
    # the leaves' bytes are exact; the f32 reward sum may move by summation
    # order between machines
    assert abs(stored.pop("reward_sum") - fresh.pop("reward_sum")) <= RSUM_TOL
    assert stored == fresh


# ---------------------------------------------------------------------------
# Wrapper contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,overrides,limits", [
    # the web app's maximum sliders under a beam wider than 4, which the
    # JAX kernel refuses too (tests/tooling/test_fused_rollout.py:182-207),
    # on a board one column wider than the wide instantiations' grid rows:
    # those take the sliders at a width of up to 6 on sides of up to 32
    # (tests/test_torch_fused_envelope.py), and no instantiation holds this
    ("rectangle_pin", {"height": 30, "width": 33,
                       "min_component_h": 1, "max_component_h": 5,
                       "min_component_w": 1, "max_component_w": 5,
                       "min_num_components": 10, "max_num_components": 40,
                       "min_num_nets": 2, "max_num_nets": 10,
                       "min_num_pins_per_net": 2, "max_num_pins_per_net": 10,
                       "reward_type": "beam", "reward_beam_width": 5},
     ("components=40", "pins=100", "pins_per_component=25",
      "beam_width=5")),
])
def test_unsupported_configs_raise(name, overrides, limits):
    params = load_env_params(name).replace(**overrides)
    assert not torch_fused.supports(params)
    _, reasons = torch_fused.envelope_report(params)
    for limit in limits:
        assert any(r.startswith(limit) for r in reasons), (limit, reasons)
    with pytest.raises(ValueError, match="envelope"):
        torch_fused.make_fused_rollout(params, 8, 5, device="cpu")


def test_envelope_and_argument_checks():
    params = load_env_params("rectangle_pin")
    assert torch_fused.supports(params)
    assert torch_fused.supports(load_env_params("rectangle_spatial_pin"))
    ok, reasons = torch_fused.envelope_report(
        params.replace(height=40, max_num_components=9,
                       min_num_components=9))
    assert not ok
    assert any(r.startswith("height=40") for r in reasons)
    assert any(r.startswith("components=9") for r in reasons)
    with pytest.raises(ValueError, match="envelope"):
        torch_fused.make_fused_rollout(params.replace(width=33), 8, 5,
                                       device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        torch_fused.make_fused_rollout(params, 12, 5, block=8,
                                       device="cpu")
    fn = torch_fused.make_fused_rollout(params, 8, 5, device="cpu")
    leaves = torch_fused.zero_leaves(params, 8, "cpu")
    with pytest.raises(ValueError, match="grid"):
        fn({**leaves, "grid": leaves["grid"].double()}, 1)
    with pytest.raises(ValueError, match="cursor"):
        fn({**leaves, "cursor": torch.zeros((4, 1), dtype=torch.int32)}, 1)


@pytest.mark.parametrize("name,overrides,reason", [
    # the reduced kernels hold up to 64 components, the pin kernels 8 (their
    # wide instantiations 64)
    ("rectangle", {"max_num_components": 65, "min_num_components": 65},
     "components_nopin=65 > 64"),
    ("rectangle_pin", {"max_num_components": 65, "min_num_components": 65,
                       "reward_type": "beam"},
     "components=65 > 64"),
    # the beam width is checked only where a beam is routed; past 4 it needs
    # both sides within 32 (the wide6 instantiations)
    ("rectangle_pin", {"height": 3, "width": 48, "reward_type": "beam",
                       "reward_beam_width": 5}, "beam_width=5 > 4"),
    ("rectangle_pin", {"height": 36, "width": 4, "reward_type": "both",
                       "reward_beam_width": 5}, "beam_width=5 > 4"),
])
def test_envelope_rejects_over_capacity(name, overrides, reason):
    params = load_env_params(name).replace(**overrides)
    ok, reasons = torch_fused.envelope_report(params)
    assert not ok and reason in reasons, reasons
    with pytest.raises(ValueError, match=reason):
        torch_fused.make_fused_rollout(params, 8, 5, device="cpu")


def test_envelope_splits_pin_and_reduced_capacities():
    """SQUARE / RECT are held to the grid and components_nopin only (as the
    JAX envelope_report splits them); the centroid reward ignores the beam
    width."""
    rect = load_env_params("rectangle")
    assert rect.max_components == 20 > torch_fused.KERNEL_CAPACITY[
        "components"]
    assert torch_fused.envelope_report(rect) == (True, [])
    assert torch_fused.envelope_report(rect.replace(
        max_num_components=64, min_num_components=64)) == (True, [])
    assert torch_fused.envelope_report(
        load_env_params("square").replace(height=32, width=32)) == (True, [])
    wide = load_env_params("rectangle_pin").replace(reward_beam_width=9)
    assert torch_fused.envelope_report(wide) == (True, [])
    ok, reasons = torch_fused.envelope_report(
        load_env_params("square").replace(height=33, width=33,
                                          component_n=2))
    assert not ok and reasons == ["height=33 > 32", "width=33 > 32"]


def test_call_sums_per_board_results():
    params = load_env_params("rectangle_pin")
    leaves = torch_fused.zero_leaves(params, 16, "cpu")
    fn = torch_fused.make_fused_rollout(params, 16, 12, block=8,
                                        device="cpu")
    new, rsum, dcnt = fn(leaves, 3)
    new_b, rsum_b, dcnt_b = fn.per_board(leaves, 3)
    _assert_leaves_equal(torch_fused.leaves_to_numpy(new),
                         torch_fused.leaves_to_numpy(new_b))
    assert float(rsum) == float(torch.sum(rsum_b))
    assert int(dcnt) == int(dcnt_b.sum()) == 16 * 3
    assert fn.launches == 0


def test_default_device_is_the_card():
    """Without a device the wrapper is built for the card: CPU leaves are
    refused by the leaf-device check, never run on the CPU."""
    params = load_env_params("rectangle_pin")
    fn = torch_fused.make_fused_rollout(params, 8, 5)
    assert fn.device.type == "cuda"
    with pytest.raises(ValueError, match="expected cuda"):
        fn(torch_fused.zero_leaves(params, 8, "cpu"), 1)
    assert fn.launches == 0


def test_kernel_build_is_keyed_on_sources():
    names = [p.name for p in _build.sources()]
    for name in ("fused_rollout.cu", "fused_rollout_warp.cu",
                 "fused_common.cuh", "fused_warp.cuh"):
        assert name in names
    assert _build.source_hash() in _build.library_path().name
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert not any("fast" in f for f in _build.NVCC_FLAGS)


def stub_nvcc(tmp_path, monkeypatch) -> pathlib.Path:
    """Point ``_build`` at an nvcc that logs its arguments to the returned
    file and touches its ``-o`` output, building into ``tmp_path/out``."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\necho "$@" >> ' + str(calls) + '\n'
                    'out=""; prev=""\n'
                    'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; '
                    'prev="$a"; done\n'
                    'echo "ptxas info: $out"\ntouch "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    return calls


def test_kernel_build_runs_one_nvcc_per_source(tmp_path, monkeypatch):
    """Each .cu is compiled by its own nvcc (all started together), then
    the objects are linked into the library; the compilers' output is
    kept beside it and no object is left behind."""
    calls = stub_nvcc(tmp_path, monkeypatch)
    lib, _ = _build.build()
    cus = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    lines = calls.read_text().splitlines()
    assert len(lines) == len(cus) + 1
    assert sorted(line.split()[-1].rsplit("/", 1)[-1]
                  for line in lines[:-1]) == cus
    assert all("-c" in line.split() and "-fmad=false" in line.split()
               for line in lines[:-1])
    assert "-shared" in lines[-1].split()
    assert lib.exists() and lib.with_suffix(".log").read_text().count(
        "ptxas info") == len(cus)
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name])
    assert _build.build() == (lib, 0.0)      # reused while the hash holds


def test_centroid_specialisation_is_the_warp_kernel():
    """K_CENTROID launches the pin kernels' one-warp-per-board template;
    the source of the C entry points keeps no K_CENTROID instantiation."""
    entry = (_build.CSRC / "fused_rollout.cu").read_text()
    warp = (_build.CSRC / "fused_rollout_warp.cu").read_text()
    assert "launch<K_CENTROID>" not in entry
    assert "return fused_rollout_warp_launch(" in entry
    assert "__global__" in warp and "fused_rollout_warp_launch(" in warp
    assert torch_fused.KERNELS[0] == "centroid"


def test_beam_and_both_are_the_warp_kernel():
    """K_BEAM and K_BOTH launch instantiations of the pin kernels'
    one-warp-per-board template, beside K_CENTROID's; the source of the C
    entry points instantiates only the reduced kernels."""
    entry = (_build.CSRC / "fused_rollout.cu").read_text()
    warp = (_build.CSRC / "fused_rollout_warp.cu").read_text()
    for k in ("K_CENTROID", "K_BEAM", "K_BOTH"):
        assert f"launch<{k}>" not in entry
        assert f"launch<{k}>(" in warp
    for k in ("K_SQUARE", "K_RECT"):
        assert f"launch<{k}>(" in entry and f"launch<{k}>" not in warp
    # no pin code beside the reduced kernels
    for name in ("beam_wl_int", "centroid_wl_int", "routed_reward",
                 "allocate_net", "extra_pins", "pnet"):
        assert name not in entry, name
    assert torch_fused.KERNELS[1:3] == ("beam", "both")


def test_reduced_kernels_are_warp_kernels():
    """SQUARE and RECT run one warp per board like the pin kernels: no
    per-board struct of arrays indexed by row, no one-thread-per-board
    kernel, and the row helpers that both layouts of kernel use are
    defined once, in the header they share."""
    texts = {p.name: p.read_text() for p in _build.sources()}
    entry = texts["fused_rollout.cu"]
    assert "struct Board" not in entry
    assert "[MAX_H]" not in "".join(texts.values())
    kernels = re.findall(r"__global__\s+void\s+__launch_bounds__\([^)]*\)"
                         r"\s*(\w+)\(", "".join(texts.values()))
    assert sorted(kernels) == ["fused_rollout_reduced_kernel",
                               "fused_rollout_warp_kernel"]
    assert "blockDim.x + threadIdx.x" not in "".join(texts.values())
    assert "const int bi = blockIdx.x * WARPS + warp;" in entry
    assert '#include "fused_warp.cuh"' in entry
    assert '#include "fused_warp.cuh"' in texts["fused_rollout_warp.cu"]
    for helper in ("free_row", "nth_cell", "plane_count", "load_rows",
                   "store_rows", "paint", "warp_scan"):
        defined = [name for name, text in texts.items() if re.search(
            rf"__device__[^;{{()]*\b{helper}\(", text)]
        assert defined == ["fused_warp.cuh"], (helper, defined)


#: every module of the port, and the smoke script (its main is guarded)
PORT_MODULES = tuple(
    m.name for m in pkgutil.walk_packages(placement_tpu_torch.__path__,
                                          "placement_tpu_torch.")
) + ("chip_smoke",)


def test_port_imports_no_jax():
    code = ("import sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'placement_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


if __name__ == "__main__":
    FIXTURES.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(INIT_K7, **k7_leaves())
    golden = zero_golden(*_jax_run("rectangle_pin",
                                   _zero("rectangle_pin", 128), 1234, 26,
                                   128))
    ZERO_B128.write_text(json.dumps(golden, indent=1, sort_keys=True) + "\n")
    print(f"wrote {INIT_K7} and {ZERO_B128}")
