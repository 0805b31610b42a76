"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
to the JAX reference's recorded numbers and to its plain PyTorch version,
then drives the port's main path — ``bench.py``'s flagship rollout:
``rectangle_pin``, 4096 boards, 50-step chunks chained output to input,
seed counter from 1 — through ``make_fused_rollout`` and reports
env-steps/s with the card's name and power limit.

Phases (any failure raises and the exit code is not 0):
  1. device  — requires CUDA; prints the card and its power limit
  2. build   — nvcc builds ops/csrc/*.cu into build/torch_kernels/
  3. TPU hardware golden — k7 start, 128 boards, 25 steps, seed 1234:
     640 episodes, reward sum of experiments/results/fused_hw_validation.json
  4. JAX golden — zero start, 128 boards, 26 steps, seed 1234: every leaf's
     sha256 as recorded from the JAX kernel (tests/fixtures)
  5. kernel vs plain PyTorch on the card at 4096 boards, block 256
  6. main path, timed; the kernel's launch count must equal the calls

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import hashlib
import json
import pathlib
import subprocess
import time

REPO = pathlib.Path(__file__).resolve().parent
BATCH, BLOCK, STEPS = 4096, 256, 50
TIMED_CHUNKS = 20
#: per 128 boards: board reward sums are added in another order than the
#: reference's (a few f32 ulps of ~1e3, ulp(1024) = 1.2e-4)
RSUM_TOL_PER_128 = 2e-3


def _check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def _leaf_sha256(t):
    import numpy as np
    arr = t.cpu().numpy()
    kind = "<f4" if arr.dtype.kind == "f" else "<i4"
    return hashlib.sha256(np.ascontiguousarray(arr, kind).tobytes()
                          ).hexdigest()


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
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "registers" in line or "spill" in line or "stack frame" in line:
            print(f"[build] {line.strip()}")


def phase_hw_golden(params):
    import numpy as np
    from placement_tpu_torch.ops import fused_rollout as fr
    hw = json.loads((REPO / "experiments" / "results"
                     / "fused_hw_validation.json").read_text())["centroid"]
    start = fr.leaves_from_numpy(
        dict(np.load(REPO / "tests" / "fixtures"
                     / "torch_fused_init_k7_b128.npz")), "cuda")
    fn = fr.make_fused_rollout(params, 128, 25, block=128, device="cuda")
    _, rsum, dcnt = fn(start, 1234)
    rsum, dcnt = float(rsum), int(dcnt)
    print(f"[hw golden] episodes {dcnt} (want {hw['episodes']}), reward sum "
          f"{rsum!r} (TPU {hw['reward_sum']})")
    _check(dcnt == hw["episodes"] == 640, "hardware golden episode count")
    _check(abs(rsum - hw["reward_sum"]) <= RSUM_TOL_PER_128,
           "hardware golden reward sum")


def phase_jax_golden(params):
    from placement_tpu_torch.ops import fused_rollout as fr
    want = json.loads((REPO / "tests" / "fixtures"
                       / "torch_fused_zero_b128.json").read_text())
    fn = fr.make_fused_rollout(params, want["batch"], want["num_steps"],
                               block=want["block"], device="cuda")
    out, rsum, dcnt = fn(fr.zero_leaves(params, want["batch"], "cuda"),
                         want["seed"])
    bad = [k for k in fr._LEAVES if _leaf_sha256(out[k]) != want["sha256"][k]]
    rsum, dcnt = float(rsum), int(dcnt)
    print(f"[jax golden] leaves differing: {bad}; episodes {dcnt} (want "
          f"{want['done_count']}), reward sum {rsum!r} (JAX "
          f"{want['reward_sum']!r})")
    _check(not bad, f"leaves differ from the JAX kernel: {bad}")
    _check(dcnt == want["done_count"] == 768, "JAX golden episode count")
    _check(abs(rsum - want["reward_sum"]) <= RSUM_TOL_PER_128,
           "JAX golden reward sum")


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


def _plain_ms(params, leaves, seed):
    import torch
    from placement_tpu_torch.ops import fused_rollout as fr
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fr.rollout_chunk_reference(params, leaves, seed, STEPS, BLOCK)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_kernel_vs_plain(params):
    import torch
    from placement_tpu_torch.ops import fused_rollout as fr
    fn = fr.make_fused_rollout(params, BATCH, STEPS, block=BLOCK,
                               device="cuda")
    leaves = fr.zero_leaves(params, BATCH, "cuda")
    got, got_r, got_d = fn.per_board(leaves, 1)
    want, want_r, want_d = fr.rollout_chunk_reference(params, leaves, 1,
                                                      STEPS, BLOCK)
    torch.cuda.synchronize()
    bad = [k for k in fr._LEAVES if not torch.equal(got[k], want[k])]
    leaf_err = max(float((got[k].double() - want[k].double()).abs().max())
                   for k in fr._LEAVES)
    board_err = float((got_r - want_r).abs().max())
    sum_err = abs(float(got_r.sum()) - float(want_r.sum()))
    print(f"[kernel vs plain] {BATCH} boards, block {BLOCK}, {STEPS} steps: "
          f"leaves differing {bad}, max |leaf diff| {leaf_err!r}, done "
          f"counts equal {torch.equal(got_d, want_d)}, max |board reward "
          f"diff| {board_err!r}, |reward sum diff| {sum_err!r}")
    _check(not bad, f"kernel leaves differ from the plain version: {bad}")
    _check(torch.equal(got_d, want_d), "kernel done counts differ")
    _check(sum_err <= RSUM_TOL_PER_128 * BATCH / 128,
           "kernel reward sum differs")

    # times at the main path's shape, in turns: plain, kernel, kernel, plain
    plain = [_plain_ms(params, got, 2)]
    kernel = [_kernel_ms(fn, got, 10, TIMED_CHUNKS),
              _kernel_ms(fn, got, 100, TIMED_CHUNKS)]
    plain.append(_plain_ms(params, got, 3))
    print(f"[kernel vs plain] ms per {STEPS}-step chunk: kernel {kernel!r}, "
          f"plain {plain!r}")
    return max(leaf_err, board_err), min(kernel), min(plain)


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
    plain_ms = _plain_ms(params, leaves, counter)
    print(f"[main path] plain PyTorch version: {plain_ms!r} ms per chunk at "
          f"the same shape")
    return launches, rate


def main():
    name = phase_device()
    from placement_tpu_torch.utils.config import load_env_params
    params = load_env_params("rectangle_pin")
    phase_build()
    phase_hw_golden(params)
    phase_jax_golden(params)
    err, kernel_ms, plain_ms = phase_kernel_vs_plain(params)
    hw = json.loads((REPO / "experiments" / "results"
                     / "fused_hw_validation.json").read_text())["centroid"]
    launches, _ = phase_main_path(params, hw["mean_reward"])
    import torch
    print(json.dumps({"kernels": [{
        "name": "fused_rollout",
        "route": "cuda",
        "source": "placement_tpu_torch/ops/csrc/fused_rollout.cu",
        "replaces": "placement_tpu/ops/fused_rollout.py:866",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
