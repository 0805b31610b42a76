"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
of the six specialisations of the fused rollout kernel (centroid, beam and
"both" rewards on the pin environments; varying pins per net; the SQUARE and
RECT reduced kernels) to the JAX reference's recorded numbers and to its
plain PyTorch version, then drives the port's three main paths through the
entry points a user calls:

  * ``bench.py``'s flagship rollout (``rectangle_pin``, centroid reward,
    4096 boards, 50-step chunks chained output to input) through
    ``make_fused_rollout``;
  * the throughput matrix, ``placement_tpu_torch.tools.bench_matrix``: its
    six fused rows at 4096 boards;
  * the sharded rollout, ``placement_tpu_torch.parallel.mesh.
    shard_fused_rollout``, on the web app's Train-page default (the flagship
    with 2..6 pins per net) at 4096 boards: one rank in this process, then
    two spawned ranks of 2048 boards (gloo on one card, NCCL on two or
    more).

Phases (any failure raises and the exit code is not 0):
  1. device  — requires CUDA; prints the card and its power limit
  2. build   — one nvcc per ops/csrc/*.cu, all at once, linked into
     build/torch_kernels/; reports ``ptxas -v`` for every kernel
  3. TPU hardware goldens — k7 start, 128 boards, seed 1234, block 128: the
     rows of experiments/results/fused_hw_validation.json
  4. JAX goldens — zero start, 128 boards, seed 1234 (the varying-pins
     configs: 1234 then 1235, chained), block 128: every leaf's sha256 as
     recorded from the JAX kernel (tests/fixtures)
  5. kernel vs plain PyTorch on the card for every fused row of the matrix
     (its config and block) and both varying-pins configs at 4096 boards,
     50 steps, and the three warp kernels (centroid, beam, "both") at 1004
     boards (a partial CUDA block); times of both, the kernel's after a
     warm-up of the card; the centroid and beam kernels' times at 1024,
     4096 and 16384 boards; each varying-pins config's time under each
     routing reward
  6. main path 1, timed; the kernel's launch count must equal the calls
  7. main path 2, the matrix; launch counts set to 0 before and read after:
     every specialisation must have launched
  8. main path 3, the sharded rollout; one rank timed, its launches equal
     to its calls and its leaves to ``make_fused_rollout``'s; each of two
     ranks' leaves equal to the one-process kernel on its shard at seed +
     rank, and the reduced totals to the sums of the ranks' own

Every timed window follows at least ``WARM_S`` seconds of chained launches:
a card fresh from idle runs its first ~50 ms slower while its clock ramps.

The second-to-last line is the kernels' JSON record, each with its bound
(``_chunk_bound``); the last line is ``{"ok": true, "device": {...}}``.
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
#: the TPU centroid golden's own tolerance (tests/tooling/
#: test_fused_rollout.py:247-276)
HW_CENTROID_TOL = 5e-4
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
#: specialisation 6, PIN with max_num_pins_per_net > min_num_pins_per_net
#: (a branch of the generator in the pin instantiations): config (its JAX
#: golden's) -> logical block at 4096 boards, that of the matrix row with
#: the same reward. "web" is main path 3's config.
VARPIN = {"varpin_web": 256, "varpin_parity": 128}
#: recorded JAX goldens: name -> fixture
JAX_GOLDENS = {
    "centroid": "torch_fused_zero_b128.json",
    **{k: f"torch_fused_zero_b128_{k}.json"
       for k in ("beam", "both", "square", "rect", "spatial", *VARPIN)},
}
#: main path 3's ranks: chained seeds
RANK_SEEDS = (1, 2)
#: the warp kernels (one warp per board, 8 boards per CUDA block) at a
#: batch that leaves a partial CUDA block, and its logical block
PARTIAL_BATCH, PARTIAL_BLOCK = 1004, 4
#: the matrix rows held to plain at that batch: one per warp kernel
PARTIAL_ROWS = ("pin_centroid", "pin_beam", "pin_both")
#: boards at which the centroid and beam kernels are timed for their scaling
SCALING_BATCHES = (1024, 4096, 16384)
#: seconds of chained launches before every timed window
WARM_S = 0.5
#: kernel sources, by specialisation
SOURCES = {k: "placement_tpu_torch/ops/csrc/fused_rollout_warp.cu"
           for k in ("centroid", "beam", "both")}
SOURCES.update({k: "placement_tpu_torch/ops/csrc/fused_rollout.cu"
                for k in ("square", "rect")})

#: an H100 SXM's rates (NVIDIA's data sheet and Hopper white paper): HBM3
#: bytes/s; non-tensor instructions, 128 lanes an SM a clock over 132 SMs
#: at the 1.98 GHz boost clock, of which 64 lanes may be integer
HBM_BYTES_S = 3.35e12
LANE_OPS_S = 132 * 128 * 1.98e9
INT_OPS_S = 132 * 64 * 1.98e9


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
        m = re.search(r"Compiling entry function '.*fused_rollout_(warp_)?"
                      r"kernelILi(\d)E", line)
        if m:
            label = fused_rollout.KERNELS[int(m.group(2))] + (
                " (one warp per board)" if m.group(1) else "")
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
    tol = {"centroid": HW_CENTROID_TOL, "beam": BEAM_HW_TOL,
           "both": BEAM_HW_TOL}.get(kernel, 0.0)
    _check(abs(diff) <= tol, f"{kernel} hardware golden reward sum")


def _golden_params(want):
    from placement_tpu_torch.utils.config import load_env_params
    return load_env_params(want["config"]).replace(
        **want.get("overrides", {}))


def phase_jax_golden(name):
    from placement_tpu_torch.ops import fused_rollout as fr
    want = json.loads((FIXTURES / JAX_GOLDENS[name]).read_text())
    params = _golden_params(want)
    fn = fr.make_fused_rollout(params, want["batch"], want["num_steps"],
                               block=want["block"], device="cuda")
    out = fr.zero_leaves(params, want["batch"], "cuda")
    rsum = dcnt = 0
    for seed in want["seeds"] if "seeds" in want else [want["seed"]]:
        out, r, d = fn(out, seed)
        rsum += float(r)
        dcnt += int(d)
    bad = [k for k in fr._LEAVES if _leaf_sha256(out[k]) != want["sha256"][k]]
    print(f"[jax golden] {name} ({fn.kernel} kernel): leaves differing "
          f"{bad}; episodes {dcnt} (JAX {want['done_count']}), reward sum "
          f"{rsum!r} (JAX {want['reward_sum']!r})")
    _check(not bad, f"{name}: leaves differ from the JAX kernel: {bad}")
    _check(dcnt == want["done_count"], f"{name} JAX golden episode count")
    tol = RSUM_TOL_PER_128 if params.has_pins else 0.0
    _check(abs(rsum - want["reward_sum"]) <= tol,
           f"{name} JAX golden reward sum")
    return want


def _warm(fn, leaves, seed=10**6):
    """Chained launches of ``fn`` for at least ``WARM_S`` seconds, so that
    the card's clock has ramped up before a timed window."""
    import torch
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARM_S:
        for _ in range(10):
            leaves, _, _ = fn.per_board(leaves, seed)
            seed += 1
        torch.cuda.synchronize()


def _kernel_ms(fn, leaves, seed, n):
    """Mean ms per chunk over n chained launches (CUDA events), after a
    warm-up."""
    import torch
    _warm(fn, leaves)
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


def _route_pairs(params, leaves):
    """Per board, averaged over ``leaves``: the pins in use, and the segment
    pairs each routing reward tests for a crossing. Both test only pairs on
    different nets. The centroid route has a segment per pin, but one for a
    2-pin net; the beam route has ``min(count, M) - 1`` per net. Returns
    (pins, centroid pairs, beam pairs)."""
    import torch
    N, M = params.max_num_nets, params.max_num_pins_per_net
    net = leaves["pin_net"].long()
    slot = torch.arange(net.shape[1], device=net.device)
    ok = (slot < leaves["num_pins"]) & (net >= 0) & (net < N)
    cnt = torch.zeros(net.shape[0], N + 1, dtype=torch.int64,
                      device=net.device)
    cnt.scatter_add_(1, torch.where(ok, net, N), torch.ones_like(net))
    cnt = cnt[:, :N]

    def pairs(seg):
        return float(((seg.sum(1) ** 2 - (seg * seg).sum(1)) // 2)
                     .double().mean())

    return (float(ok.sum(1).double().mean()),
            pairs(torch.where(cnt == 2, 1, cnt)),
            pairs((cnt.clamp(max=M) - 1).clamp(min=0)))


def _chunk_bound(params, batch, steps, episodes, leaves):
    """The least time the card could take for one chunk: bytes (every leaf
    read once and written once, plus the per-board sums) over the HBM rate,
    or the operations the kernel's code does for this data over the
    instruction rates, whichever is larger. Operations are counted from the
    code (a model, not a measurement): per board-step the action sampling, the
    paint, the pin rotation and the next legality planes; per episode
    (``episodes`` of this run, pins and crossing tests as on ``leaves``'
    boards, ``_route_pairs``) the generator and the routing reward. Returns
    (ms, "bytes" or "operations", operations, bytes)."""
    from placement_tpu_torch.ops import fused_rollout as fr
    H, C, N = params.height, params.max_components, params.max_num_nets
    M, PPC = params.max_num_pins_per_net, params.max_num_pins_per_component
    fp = max(params.max_component_h, params.max_component_w)
    kernel = fr.kernel_name(params)
    planes = 1 if kernel == "square" else 2
    step = planes * H * (2 * fp + 6) + 3 * H + 40 + fp
    gen = 10 * C
    route_int = route_fp = 0.0
    if params.has_pins:
        pins, centroid_pairs, beam_pairs = _route_pairs(params, leaves)
        step += 10 * params.max_pins
        gen = (N * (4 * C * C + 4 * M * C + 20) + 2 * C * PPC * PPC
               + pins * (N + 15) + 20 * C)
        if params.max_num_pins_per_net > params.min_num_pins_per_net:
            span = params.max_num_pins_per_net - params.min_num_pins_per_net
            gen += 60 * N + span * N * N
        if kernel in ("centroid", "both"):
            route_int += 20 * pins + 10 * N
            route_fp += 35 * centroid_pairs
        if kernel in ("beam", "both"):
            bw = int(params.reward_beam_width)
            rounds = max(pins / N - 1, 0)
            route_int += N * rounds * bw * (6 * M + 2 * bw * M + 8 * bw * bw)
            route_fp += 35 * beam_pairs
    ops_int = batch * steps * step + episodes * (gen + route_int)
    ops_fp = episodes * route_fp
    nbytes = 2 * 4 * batch * sum(fr.leaf_widths(params).values()) + 8 * batch
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(ops_int / INT_OPS_S, (ops_int + ops_fp) / LANE_OPS_S)
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, ops_int + ops_fp, nbytes


def phase_kernel_vs_plain(label, params, block, batch=BATCH):
    """The kernel against its plain version on ``params`` at ``batch``
    boards and logical ``block``, two chained chunks; returns (max abs
    error, kernel ms per chunk, plain ms per chunk, bound ms, bound_by)."""
    import torch
    from placement_tpu_torch.ops import fused_rollout as fr
    label += f" ({fr.kernel_name(params)} kernel)"
    fn = fr.make_fused_rollout(params, batch, STEPS, block=block,
                               device="cuda")
    leaves = fr.zero_leaves(params, batch, "cuda")
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
        print(f"[kernel vs plain] {label}: {batch} boards, block {block}, "
              f"{STEPS} steps, seed {seed}: leaves differing {bad}, done "
              f"counts equal {torch.equal(got_d, want_d)}, max |board "
              f"reward diff| {err!r} (equal: {torch.equal(got_r, want_r)}),"
              f" {int(got_d.sum())} episodes")
        _check(not bad, f"{label}: kernel leaves differ from the plain "
                        f"version: {bad}")
        _check(torch.equal(got_d, want_d), f"{label}: done counts differ")
        if params.has_pins and params.reward_type != "beam":
            # the centroid route's terms are added in another order
            _check(err <= 1e-5, f"{label}: board rewards differ")
        else:
            _check(torch.equal(got_r, want_r), f"{label}: rewards differ")
        leaves = got
    err = max(leaf_err, board_err)
    # the bound of the second chunk (from mid-run boards) on its own data
    bound_ms, bound_by, ops, nbytes = _chunk_bound(
        params, batch, STEPS, int(got_d.sum()), leaves)
    # in turns: plain, kernel, kernel, plain
    plain = [_plain_ms(params, leaves, 3, block)]
    kernel_ms = [_kernel_ms(fn, leaves, 10, TIMED_CHUNKS),
                 _kernel_ms(fn, leaves, 100, TIMED_CHUNKS)]
    plain.append(_plain_ms(params, leaves, 4, block))
    print(f"[kernel vs plain] {label}: ms per {STEPS}-step chunk: kernel "
          f"{kernel_ms!r}, plain {plain!r}; bound {bound_ms!r} ms by "
          f"{bound_by} ({ops!r} operations, {nbytes} bytes); share of "
          f"bound (bound / kernel ms) {bound_ms / min(kernel_ms)!r}")
    return err, min(kernel_ms), min(plain), bound_ms, bound_by


def phase_batch_scaling(params, block):
    """The kernel's ms per chunk on ``params`` at several batches (from
    mid-run boards, after a warm-up): flat means latency-bound, in
    proportion to the boards means throughput-bound."""
    from placement_tpu_torch.ops import fused_rollout as fr
    for batch in SCALING_BATCHES:
        fn = fr.make_fused_rollout(params, batch, STEPS, block=block,
                                   device="cuda")
        leaves, _, _ = fn.per_board(fr.zero_leaves(params, batch, "cuda"), 1)
        ms = [_kernel_ms(fn, leaves, 10 * i, TIMED_CHUNKS) for i in (1, 2)]
        print(f"[batch] {fn.kernel} kernel, {batch} boards: ms per chunk "
              f"{ms!r}, {batch * STEPS / min(ms) * 1e3!r} env-steps/s")


def phase_reward_split(label, params, block):
    """The warp kernel's ms per chunk on ``params`` under each routing
    reward (from mid-run boards, after a warm-up): what the routes cost
    beside the rest of the step."""
    from placement_tpu_torch.ops import fused_rollout as fr
    ms = {}
    for reward in ("centroid", "beam", "both"):
        fn = fr.make_fused_rollout(params.replace(reward_type=reward), BATCH,
                                   STEPS, block=block, device="cuda")
        leaves, _, _ = fn.per_board(fr.zero_leaves(params, BATCH, "cuda"), 1)
        ms[reward] = _kernel_ms(fn, leaves, 10, TIMED_CHUNKS)
    print(f"[reward split] {label}, {BATCH} boards, block {block}: ms per "
          f"chunk by reward {ms!r}")


def phase_main_path(params, ref_mean):
    """bench.py's fused phase on the port: one warm-up chunk, then timed
    chunks chained output to input, synced by fetching the reward sum."""
    import torch
    from placement_tpu_torch.ops import fused_rollout as fr
    fn = fr.make_fused_rollout(params, BATCH, STEPS, block=BLOCK,
                               device="cuda")
    leaves = fr.zero_leaves(params, BATCH, "cuda")
    _warm(fn, leaves)
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


def phase_sharded(params, block, ref_mean):
    """Main path 3: ``shard_fused_rollout`` at 4096 boards. One rank (no
    process group) in this process, timed as main path 1 and held to
    ``make_fused_rollout`` on the same seeds; then two spawned ranks of
    2048 boards, each held to the one-process kernel on its shard at seed
    + rank. Returns (kernel launches of the path, one-rank env-steps/s)."""
    import torch
    from placement_tpu_torch.ops import fused_rollout as fr
    from placement_tpu_torch.parallel import mesh
    fn = mesh.shard_fused_rollout(params, BATCH, STEPS, block=block,
                                  device="cuda")
    ref = fr.make_fused_rollout(params, BATCH, STEPS, block=block,
                                device="cuda")

    def same(a, b):
        return [k for k in fr._LEAVES if not torch.equal(a[k], b[k])]

    zero = fr.zero_leaves(params, BATCH, "cuda")
    _warm(fn.local, zero)
    fn.local.launches = 0
    leaves, racc, _ = fn(zero, 1)
    bad = same(leaves, ref(zero, 1)[0])
    _check(not bad, f"main path 3: one rank differs from the kernel: {bad}")
    float(racc)
    racc = torch.zeros((), dtype=torch.float32, device="cuda")
    dacc = torch.zeros((), dtype=torch.int64, device="cuda")
    t0 = time.perf_counter()
    for seed in range(2, 2 + TIMED_CHUNKS):
        prev = leaves
        leaves, rsum, dcnt = fn(leaves, seed)
        racc = racc + rsum
        dacc = dacc + dcnt
    reward = float(racc)              # the sync: needs every chunk's output
    dt = time.perf_counter() - t0
    launches = fn.local.launches
    episodes = int(dacc)
    rate = BATCH * STEPS * TIMED_CHUNKS / dt
    print(f"[main path 3] 1 rank: {TIMED_CHUNKS} chunks of {STEPS} steps x "
          f"{BATCH} boards in {dt!r} s: {rate!r} env-steps/s; kernel "
          f"launches {launches} for {1 + TIMED_CHUNKS} calls; {episodes} "
          f"episodes, mean episode reward {reward / episodes!r} (JAX golden's"
          f" routed mean {ref_mean!r})", flush=True)
    _check(launches == 1 + TIMED_CHUNKS, "main path 3 missed the kernel")
    bad = same(leaves, ref(prev, 1 + TIMED_CHUNKS)[0])
    _check(not bad, f"main path 3: one rank differs from the kernel: {bad}")
    # episodes are 5 placements whatever the pin count
    _check(episodes == 10 * BATCH * TIMED_CHUNKS, "episode accounting")
    _check(all(torch.isfinite(leaves[k]).all() for k in fr._FLOAT_LEAVES)
           and all(tuple(leaves[k].shape) == (BATCH, w)
                   for k, w in fr.leaf_widths(params).items()),
           "main path 3 leaves")
    _check(abs(reward / episodes - ref_mean) < 0.1, "mean episode reward")

    world = 2
    local = BATCH // world
    backend = mesh.backend_for("cuda", world)
    ranks = mesh.spawn_ranks(
        mesh.rollout_rank, world,
        args=(params, BATCH, STEPS, block, list(RANK_SEEDS), "cuda"),
        backend=backend)
    own = []
    for r, res in enumerate(ranks):
        one = fr.make_fused_rollout(params, local, STEPS, block=block,
                                    device="cuda")
        lv = fr.zero_leaves(params, local, "cuda")
        totals = []
        for seed in RANK_SEEDS:
            lv, rsum, dcnt = one(lv, seed + r)
            totals.append((float(rsum), int(dcnt)))
        own.append(totals)
        bad = same(fr.leaves_from_numpy(res["leaves"], "cuda"), lv)
        print(f"[main path 3] rank {r} of {world} ({backend}): {local} "
              f"boards, leaves differing from the one-process kernel at "
              f"seed + {r}: {bad}; launches {res['launches']} for "
              f"{len(RANK_SEEDS)} calls; reduced totals {res['totals']}, "
              f"own {totals}", flush=True)
        _check(not bad, f"main path 3: rank {r} differs: {bad}")
        _check(res["launches"] == len(RANK_SEEDS),
               f"main path 3: rank {r} missed the kernel")
    for res in ranks:
        for i, (rsum, dcnt) in enumerate(res["totals"]):
            _check(dcnt == sum(t[i][1] for t in own),
                   "main path 3: reduced episode count")
            _check(abs(rsum - sum(t[i][0] for t in own))
                   <= RSUM_TOL_PER_128 * BATCH / 128,
                   "main path 3: reduced reward sum")
    return launches + sum(res["launches"] for res in ranks), rate


def main():
    device_name = phase_device()
    import torch
    from placement_tpu_torch.ops import fused_rollout as fr
    from placement_tpu_torch.tools import bench_matrix as bm
    phase_build()
    for kernel in KERNELS:
        phase_hw_golden(kernel)
    goldens = {g: phase_jax_golden(g) for g in JAX_GOLDENS}
    results = {row: phase_kernel_vs_plain(row, *_row(row))
               for row in bm.FUSED_ROWS}
    phase_batch_scaling(*_row("pin_centroid"))
    phase_batch_scaling(*_row("pin_beam"))
    # the warp kernels with a partial CUDA block
    partial_err = {
        fr.kernel_name(_row(row)[0]): phase_kernel_vs_plain(
            f"{row} partial block", _row(row)[0], PARTIAL_BLOCK,
            batch=PARTIAL_BATCH)[0]
        for row in PARTIAL_ROWS}
    # the beam at its capacity width
    params, block = _row("pin_beam")
    err4, ms4, plain4, *_ = phase_kernel_vs_plain(
        "pin_beam bw=4", params.replace(reward_beam_width=4), block)
    for config, block in VARPIN.items():
        results[config] = phase_kernel_vs_plain(
            config, _golden_params(goldens[config]), block)
        phase_reward_split(config, _golden_params(goldens[config]), block)
    hw = json.loads(HW_GOLDENS.read_text())
    launches_1, _ = phase_main_path(_row("pin_centroid")[0],
                                    hw["centroid"]["mean_reward"])
    # references of the pin rows' mean episode reward: the TPU goldens'
    # (640 episodes each), and for the spatial config, which has none, the
    # JAX kernel's routed episodes from zero boards (768 episodes, of which
    # the first 128 are the zero boards' invalid-action penalties)
    spatial = goldens["spatial"]
    pen = fr._penalty(_golden_params(spatial))
    ref_means = {
        "pin_centroid": hw["centroid"]["mean_reward"],
        "pin_beam": hw["beam"]["mean_reward"],
        "pin_both": hw["both"]["mean_reward"],
        "spatial": (spatial["reward_sum"] - spatial["batch"] * pen)
        / (spatial["done_count"] - spatial["batch"]),
    }
    launches = phase_matrix(ref_means)
    launches["centroid"] += launches_1       # main path 1 runs it too
    web = goldens["varpin_web"]
    pen = fr._penalty(_golden_params(web))
    launches["varpin"], rate3 = phase_sharded(
        _golden_params(web), VARPIN["varpin_web"],
        (web["reward_sum"] - web["batch"] * pen)
        / (web["done_count"] - web["batch"]))
    # no one PyTorch call computes a chunk: library_ms is null
    entries = []
    for k, (row, *_, replaces) in KERNELS.items():
        err, ms, plain_ms, bound_ms, bound_by = results[row]
        err = max(err, partial_err.get(k, 0.0))
        entries.append({
            "name": f"fused_rollout_{k}",
            "route": "cuda",
            "source": SOURCES[k],
            "replaces": f"placement_tpu/ops/fused_rollout.py:866 "
                        f"({replaces})",
            "launches": launches[k],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })
    # the varying-pins branch on main path 3's config (the centroid
    # kernel); the error is the larger of both configs'
    err, ms, plain_ms, bound_ms, bound_by = results["varpin_web"]
    entries.append({
        "name": "fused_rollout_varpin",
        "route": "cuda",
        "source": SOURCES["centroid"],
        "replaces": "placement_tpu/ops/fused_rollout.py:866 (PIN, max_ppn "
                    "> min_ppn, :399-450)",
        "launches": launches["varpin"],
        "max_abs_err": max(err, results["varpin_parity"][0]),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    })
    print(f"[kernel vs plain] beam bw=4: max abs err {err4!r}, kernel "
          f"{ms4!r} ms, plain {plain4!r} ms")
    print(f"[kernel vs plain] varpin_parity: max abs err "
          f"{results['varpin_parity'][0]!r}, kernel "
          f"{results['varpin_parity'][1]!r} ms, plain "
          f"{results['varpin_parity'][2]!r} ms")
    print(f"[main path 3] one rank {rate3!r} env-steps/s vs 4096 x 50 / "
          f"kernel ms {BATCH * STEPS / results['varpin_web'][1] * 1e3!r}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
