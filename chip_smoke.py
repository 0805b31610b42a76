"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
of the five specialisations of the fused rollout kernel (centroid, beam and
"both" rewards on the pin environments; the SQUARE and RECT reduced kernels)
to the JAX reference's recorded numbers and to its plain PyTorch version,
then drives the port's two main paths through the entry points a user calls:

  * ``bench.py``'s flagship rollout (``rectangle_pin``, centroid reward,
    4096 boards, 50-step chunks chained output to input) through
    ``make_fused_rollout``;
  * the throughput matrix, ``placement_tpu_torch.tools.bench_matrix``: its
    six fused rows at 4096 boards, every specialisation of the kernel.

Phases (any failure raises and the exit code is not 0):
  1. device  — requires CUDA; prints the card and its power limit
  2. build   — nvcc builds ops/csrc/*.cu into build/torch_kernels/ and
     reports ``ptxas -v`` for every instantiation
  3. TPU hardware goldens — k7 start, 128 boards, seed 1234, block 128: the
     rows of experiments/results/fused_hw_validation.json
  4. JAX goldens — zero start, 128 boards, seed 1234, block 128: every
     leaf's sha256 as recorded from the JAX kernel (tests/fixtures)
  5. kernel vs plain PyTorch on the card for every fused row of the matrix
     (its config and block) at 4096 boards, 50 steps; times of both
  6. main path 1, timed; the kernel's launch count must equal the calls
  7. main path 2, the matrix; launch counts set to 0 before and read after:
     every specialisation must have launched

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import hashlib
import json
import pathlib
import re
import subprocess
import time

REPO = pathlib.Path(__file__).resolve().parent
FIXTURES = REPO / "tests" / "fixtures"
HW_GOLDENS = REPO / "experiments" / "results" / "fused_hw_validation.json"
BATCH, BLOCK, STEPS = 4096, 256, 50
TIMED_CHUNKS = 20
#: per 128 boards: board reward sums are added in another order than the
#: reference's (a few f32 ulps of ~1e3, ulp(1024) = 1.2e-4)
RSUM_TOL_PER_128 = 2e-3
#: the TPU's beam and "both" goldens: Mosaic's f32 division rounds the
#: outlier pin's centroid differently (test_fused_rollout.py:252-256)
BEAM_HW_TOL = 0.5

#: specialisation -> (its matrix row, TPU golden key, golden steps, k7 start
#: fixture, what of the TPU kernel it replaces). A row's config and logical
#: block are the matrix tool's own (``_row``).
KERNELS = {
    "centroid": ("pin_centroid", "centroid", 25,
                 "torch_fused_init_k7_b128.npz",
                 "PIN/PIN_SPATIAL, centroid reward"),
    "beam": ("pin_beam", "beam", 25, "torch_fused_init_k7_b128.npz",
             "PIN/PIN_SPATIAL, beam reward"),
    "both": ("pin_both", "both", 25, "torch_fused_init_k7_b128.npz",
             "PIN/PIN_SPATIAL, 'both' reward"),
    "square": ("square", "square", 60, "torch_fused_init_k7_b128_square.npz",
               "SQUARE reduced kernel"),
    "rect": ("rect", "rectangle", 30, "torch_fused_init_k7_b128_rectangle.npz",
             "RECT reduced kernel"),
}
#: recorded JAX goldens: name -> fixture
JAX_GOLDENS = {
    "centroid": "torch_fused_zero_b128.json",
    **{k: f"torch_fused_zero_b128_{k}.json"
       for k in ("beam", "both", "square", "rect", "spatial")},
}


def _check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def _leaf_sha256(t):
    import numpy as np
    arr = t.cpu().numpy()
    kind = "<f4" if arr.dtype.kind == "f" else "<i4"
    return hashlib.sha256(np.ascontiguousarray(arr, kind).tobytes()
                          ).hexdigest()


def _row(name):
    """A matrix row's config and logical block, as bench_matrix runs it."""
    from placement_tpu_torch.tools import bench_matrix as bm
    return (bm._configs()[name][0],
            bm.FUSED_TUNING.get(name, {}).get("block", 128))


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; the port's smoke run "
                           "needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(smi, flush=True)
    return name


def phase_build():
    from placement_tpu_torch.ops import _build, fused_rollout
    lib, seconds = _build.build()
    fused_rollout.kernel_library()
    print(f"[build] {lib.name}: {seconds:.1f} s of nvcc")
    log = lib.with_suffix(".log")
    label = "?"
    for line in (log.read_text().splitlines() if log.exists() else []):
        m = re.search(r"Compiling entry function '.*fused_rollout_kernelILi"
                      r"(\d)E", line)
        if m:
            label = fused_rollout.KERNELS[int(m.group(1))]
        elif "registers" in line or "spill" in line or "stack frame" in line:
            print(f"[build] {label}: {line.strip()}")


def phase_hw_golden(kernel):
    import numpy as np
    from placement_tpu_torch.ops import fused_rollout as fr
    row, key, steps, start, _ = KERNELS[kernel]
    hw = json.loads(HW_GOLDENS.read_text())[key]
    params, _ = _row(row)
    leaves = fr.leaves_from_numpy(dict(np.load(FIXTURES / start)), "cuda")
    fn = fr.make_fused_rollout(params, 128, steps, block=128, device="cuda")
    _, rsum, dcnt = fn(leaves, 1234)
    rsum, dcnt = float(rsum), int(dcnt)
    diff = rsum - hw["reward_sum"]
    print(f"[hw golden] {kernel}: episodes {dcnt} (TPU {hw['episodes']}), "
          f"reward sum {rsum!r} (TPU {hw['reward_sum']}, diff {diff!r})")
    _check(dcnt == hw["episodes"], f"{kernel} hardware golden episodes")
    tol = {"centroid": RSUM_TOL_PER_128, "beam": BEAM_HW_TOL,
           "both": BEAM_HW_TOL}.get(kernel, 0.0)
    _check(abs(diff) <= tol, f"{kernel} hardware golden reward sum")


def phase_jax_golden(name):
    from placement_tpu_torch.ops import fused_rollout as fr
    from placement_tpu_torch.utils.config import load_env_params
    want = json.loads((FIXTURES / JAX_GOLDENS[name]).read_text())
    params = load_env_params(want["config"]).replace(
        **want.get("overrides", {}))
    fn = fr.make_fused_rollout(params, want["batch"], want["num_steps"],
                               block=want["block"], device="cuda")
    out, rsum, dcnt = fn(fr.zero_leaves(params, want["batch"], "cuda"),
                         want["seed"])
    bad = [k for k in fr._LEAVES if _leaf_sha256(out[k]) != want["sha256"][k]]
    rsum, dcnt = float(rsum), int(dcnt)
    print(f"[jax golden] {name} ({fn.kernel} kernel): leaves differing "
          f"{bad}; episodes {dcnt} (JAX {want['done_count']}), reward sum "
          f"{rsum!r} (JAX {want['reward_sum']!r})")
    _check(not bad, f"{name}: leaves differ from the JAX kernel: {bad}")
    _check(dcnt == want["done_count"], f"{name} JAX golden episode count")
    tol = RSUM_TOL_PER_128 if params.has_pins else 0.0
    _check(abs(rsum - want["reward_sum"]) <= tol,
           f"{name} JAX golden reward sum")
    return want


def _kernel_ms(fn, leaves, seed, n):
    """Mean ms per chunk over n chained launches (CUDA events)."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(n):
        leaves, _, _ = fn.per_board(leaves, seed + i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _plain_ms(params, leaves, seed, block):
    import torch
    from placement_tpu_torch.ops import fused_rollout as fr
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fr.rollout_chunk_reference(params, leaves, seed, STEPS, block)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_kernel_vs_plain(row, beam_width=None):
    """The kernel against its plain version at the matrix row's shape
    (at ``beam_width`` if given); returns (max abs error, kernel ms per
    chunk, plain ms per chunk)."""
    import torch
    from placement_tpu_torch.ops import fused_rollout as fr
    params, block = _row(row)
    label = row
    if beam_width is not None:
        params = params.replace(reward_beam_width=beam_width)
        label = f"{row} bw={beam_width}"
    label += f" ({fr.kernel_name(params)} kernel)"
    fn = fr.make_fused_rollout(params, BATCH, STEPS, block=block,
                               device="cuda")
    leaves = fr.zero_leaves(params, BATCH, "cuda")
    leaf_err = board_err = 0.0
    for seed in (1, 2):        # from zero boards, then from mid-run boards
        got, got_r, got_d = fn.per_board(leaves, seed)
        want, want_r, want_d = fr.rollout_chunk_reference(
            params, leaves, seed, STEPS, block)
        torch.cuda.synchronize()
        bad = [k for k in fr._LEAVES if not torch.equal(got[k], want[k])]
        leaf_err = max(leaf_err, max(
            float((got[k].double() - want[k].double()).abs().max())
            for k in fr._LEAVES))
        err = float((got_r - want_r).abs().max())
        board_err = max(board_err, err)
        print(f"[kernel vs plain] {label}: {BATCH} boards, block {block}, "
              f"{STEPS} steps, seed {seed}: leaves differing {bad}, done "
              f"counts equal {torch.equal(got_d, want_d)}, max |board "
              f"reward diff| {err!r} (equal: {torch.equal(got_r, want_r)}),"
              f" {int(got_d.sum())} episodes")
        _check(not bad, f"{label}: kernel leaves differ from the plain "
                        f"version: {bad}")
        _check(torch.equal(got_d, want_d), f"{label}: done counts differ")
        if params.has_pins:
            _check(err <= 1e-5, f"{label}: board rewards differ")
        else:
            _check(torch.equal(got_r, want_r), f"{label}: rewards differ")
        leaves = got
    # in turns: plain, kernel, kernel, plain
    plain = [_plain_ms(params, leaves, 3, block)]
    kernel_ms = [_kernel_ms(fn, leaves, 10, TIMED_CHUNKS),
                 _kernel_ms(fn, leaves, 100, TIMED_CHUNKS)]
    plain.append(_plain_ms(params, leaves, 4, block))
    print(f"[kernel vs plain] {label}: ms per {STEPS}-step chunk: kernel "
          f"{kernel_ms!r}, plain {plain!r}")
    return max(leaf_err, board_err), min(kernel_ms), min(plain)


def phase_main_path(params, ref_mean):
    """bench.py's fused phase on the port: one warm-up chunk, then timed
    chunks chained output to input, synced by fetching the reward sum."""
    import torch
    from placement_tpu_torch.ops import fused_rollout as fr
    fn = fr.make_fused_rollout(params, BATCH, STEPS, block=BLOCK,
                               device="cuda")
    leaves = fr.zero_leaves(params, BATCH, "cuda")
    counter = 1
    fn.launches = 0
    leaves, racc, _ = fn(leaves, counter)
    counter += 1
    float(racc)
    racc = torch.zeros((), dtype=torch.float32, device="cuda")
    dacc = torch.zeros((), dtype=torch.int64, device="cuda")
    t0 = time.perf_counter()
    for _ in range(TIMED_CHUNKS):
        leaves, rsum, dcnt = fn(leaves, counter)
        counter += 1
        racc = racc + rsum
        dacc = dacc + dcnt
    reward = float(racc)              # the sync: needs every chunk's output
    dt = time.perf_counter() - t0
    launches = fn.launches
    episodes = int(dacc)
    rate = BATCH * STEPS * TIMED_CHUNKS / dt
    print(f"[main path] {TIMED_CHUNKS} chunks of {STEPS} steps x {BATCH} "
          f"boards in {dt!r} s: {rate!r} env-steps/s; kernel launches "
          f"{launches} for {1 + TIMED_CHUNKS} calls; {episodes} episodes, "
          f"mean episode reward {reward / episodes!r}")
    _check(launches == 1 + TIMED_CHUNKS, "main path missed the kernel")
    # flagship episodes are exactly 5 placements: 10 per board per chunk
    _check(episodes == 10 * BATCH * TIMED_CHUNKS, "episode accounting")
    _check(all(torch.isfinite(leaves[k]).all() for k in fr._FLOAT_LEAVES)
           and all(tuple(leaves[k].shape) == (BATCH, w)
                   for k, w in fr.leaf_widths(params).items()),
           "main path leaves")
    # the routed episode reward agrees with the TPU golden's mean
    # (640 episodes, std ~0.35: standard error ~0.014)
    _check(abs(reward / episodes - ref_mean) < 0.1, "mean episode reward")
    return launches, rate


def phase_matrix(ref_means):
    """The throughput matrix's fused rows at 4096 boards, through
    bench_matrix.measure; returns each specialisation's launches, totalled
    over the rows (each row's wrapper counts from 0)."""
    import torch
    from placement_tpu_torch.ops import fused_rollout as fr
    from placement_tpu_torch.tools import bench_matrix as bm
    table = bm._configs()
    launches = {k: 0 for k in fr.KERNELS}
    rows = {}
    for name in bm.FUSED_ROWS:
        params, anchor = table[name]
        row, leaves = bm.measure(name, params, anchor, BATCH, "cuda",
                                 block=_row(name)[1])
        rows[name] = row
        launches[row["kernel"]] += row["launches"]
        print(f"[matrix] {name}: {row['kernel']} kernel, block "
              f"{row['block']}, {row['steps_per_sec']!r} env-steps/s, "
              f"{row['launches']} launches for {row['calls']} calls, "
              f"{row['episodes']} episodes, mean episode reward "
              f"{row['mean_episode_reward']!r}; {row['card']}")
        _check(row["launches"] == row["calls"],
               f"matrix row {name} missed the kernel")
        _check(all(torch.isfinite(leaves[k]).all() for k in fr._FLOAT_LEAVES)
               and all(tuple(leaves[k].shape) == (BATCH, w)
                       for k, w in fr.leaf_widths(params).items()),
               f"matrix row {name} leaves")
        _check(row["episodes"] > 0, f"matrix row {name} finished nothing")
        if name in ref_means:
            _check(abs(row["mean_episode_reward"] - ref_means[name]) < 0.1,
                   f"matrix row {name} mean episode reward "
                   f"{row['mean_episode_reward']} vs {ref_means[name]}")
    print(f"[matrix] kernel launches in the matrix run: {launches}")
    _check(all(launches[k] > 0 for k in KERNELS),
           f"the matrix run missed a kernel: {launches}")
    print(json.dumps({"matrix": rows}))
    return launches


def main():
    name = phase_device()
    import torch
    from placement_tpu_torch.ops import fused_rollout as fr
    from placement_tpu_torch.tools import bench_matrix as bm
    phase_build()
    for kernel in KERNELS:
        phase_hw_golden(kernel)
    goldens = {g: phase_jax_golden(g) for g in JAX_GOLDENS}
    results = {row: phase_kernel_vs_plain(row) for row in bm.FUSED_ROWS}
    # the beam at its capacity width
    err4, ms4, plain4 = phase_kernel_vs_plain("pin_beam", beam_width=4)
    hw = json.loads(HW_GOLDENS.read_text())
    phase_main_path(_row("pin_centroid")[0], hw["centroid"]["mean_reward"])
    # references of the pin rows' mean episode reward: the TPU goldens'
    # (640 episodes each), and for the spatial config, which has none, the
    # JAX kernel's routed episodes from zero boards (768 episodes, of which
    # the first 128 are the zero boards' invalid-action penalties)
    from placement_tpu_torch.utils.config import load_env_params
    spatial = goldens["spatial"]
    pen = fr._penalty(load_env_params(spatial["config"]))
    ref_means = {
        "pin_centroid": hw["centroid"]["mean_reward"],
        "pin_beam": hw["beam"]["mean_reward"],
        "pin_both": hw["both"]["mean_reward"],
        "spatial": (spatial["reward_sum"] - spatial["batch"] * pen)
        / (spatial["done_count"] - spatial["batch"]),
    }
    launches = phase_matrix(ref_means)
    entries = []
    for k, (row, *_, replaces) in KERNELS.items():
        err, ms, plain_ms = results[row]
        entries.append({
            "name": f"fused_rollout_{k}",
            "route": "cuda",
            "source": "placement_tpu_torch/ops/csrc/fused_rollout.cu",
            "replaces": f"placement_tpu/ops/fused_rollout.py:866 "
                        f"({replaces})",
            "launches": launches[k],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
        })
    print(f"[kernel vs plain] beam bw=4: max abs err {err4!r}, kernel "
          f"{ms4!r} ms, plain {plain4!r} ms")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
