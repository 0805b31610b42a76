"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
of the six specialisations of the fused rollout kernel (centroid, beam and
"both" rewards on the pin environments; varying pins per net; the SQUARE and
RECT reduced kernels) to the JAX reference's recorded numbers and to its
plain PyTorch version, then drives the port's main paths through the
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
    more);
  * the general stepper, ``random_policy.simulate`` -> ``core.make_batched``
    (reset, step with auto-reset, observe) on every env family and reward,
    and the fused kernel started from its reset boards;
  * the policy path: the flagship model with Flax weights carried across
    (``Policy.load_flax``) acting on 4096 boards through the pooled
    auto-reset engine (``pooled.rollout_chunk``), the random policy through
    the same engine, the matrix's ``web_max_pooled`` row on it, and
    ``graft_entry.entry``;
  * the learner: ``Trainer("rectangle_pin")`` training the flagship from
    its carried Flax weights with RLlib's PPO defaults (``Policy.evaluate``,
    ``agent/ppo.py``), checkpointed, restored and continued, its rollouts
    exported; every other preset's minibatch step held card to CPU and
    one iteration of it trained; PPO learning the tiny square env; the
    learning-curve
    runners' training of the spatial flagship held to JAX's seed band;
    and the same training data-parallel over ranks
    (``Trainer(mesh=...)``);
  * the tooling around the package: the model zoo's repaired conv
    settings, the random-policy runners, the three profilers
    (``tools/{train_profile,pooled_profile,price_exact_sampling}``) and
    the web app's data layer over the trained run.

Phases (any failure raises and the exit code is not 0):
  1. device  — requires CUDA; prints the card and its power limit
  2. build   — one nvcc per ops/csrc/*.cu, all at once, linked into
     build/torch_kernels/; reports ``ptxas -v`` for every kernel, and each
     pin instantiation's registers, stack frame, spill stores and boards
     resident per SM; each general one must hold 32 boards per SM (all
     4,096 at once)
  3. TPU hardware goldens — k7 start, 128 boards, seed 1234, block 128: the
     rows of experiments/results/fused_hw_validation.json
  4. JAX goldens — zero start, 128 boards, seed 1234 (the varying-pins
     configs: 1234 then 1235, chained), block 128: every leaf's sha256 as
     recorded from the JAX kernel (tests/fixtures)
  5. kernel vs plain PyTorch on the card for every fused row of the matrix
     (its config and block) and both varying-pins configs at 4096 boards,
     50 steps, and one row per kernel at 1004 boards (a partial CUDA
     block); the reduced kernels at their capacity shapes (SQUARE with
     n = 3, RECT with 64 components, a 32x32 grid); times of both, the
     kernel's after a warm-up of the card, with the host's launches
     enqueued ahead of the card; the centroid, beam and rect kernels'
     times at 1024, 4096 and 16384 boards; each varying-pins config's time
     under each routing reward
  5b. [envelope]: the general instantiations (up to 24 nets, 48 pins per
     net, a side over 32 at area <= 144) on the nine edges of the JAX
     kernel's envelope (tests/fixtures/torch_fused_zero_envelope_*.json):
     leaf hashes equal to the JAX kernel's at the fixture's size, kernel ==
     plain at 4096 boards (timed, with its bound), and the matrix
     tool's fused row on each, its launches equal to its calls; four of
     them timed under each routing reward, four at 1024, 4096 and 16384
     boards; the flagship's
     rows forced onto the general instantiation, leaves and time beside
     the default one's
  5c. [wide]: the web app's largest boards (``web_max_pooled``'s 30x30
     grid, 40 components, 10 nets of 2..10 pins) on the wide instantiation
     of the centroid kernel: kernel == plain at 4096 boards on a 10-step
     chunk from mid-run boards (board rewards within 5e-4), timed with its
     bound, and the matrix tool's fused row on it
  5d. [wide beam]: the same boards on the wide instantiations of the beam
     kernel (width 4) and of the "both" kernel (widths 2 and 4): three
     chained chunks at 4096 boards from zero boards, each held to
     ``portbench/reference_wide_beam.py`` (leaves and done counts equal,
     beam rewards equal, "both" rewards within 5e-4), timed with the
     bound, beside the centroid kernel's time on the same boards
  6. main path 1, timed; the kernel's launch count must equal the calls
  7. main path 2, the matrix; launch counts set to 0 before and read after:
     every specialisation must have launched; the square and rect rows'
     rates beside 4096 x 50 / kernel ms (what the host's enqueue costs)
  8. main path 3, the sharded rollout; one rank timed, its launches equal
     to its calls and its leaves to ``make_fused_rollout``'s; each of two
     ranks' leaves equal to the one-process kernel on its shard at seed +
     rank, and the reduced totals to the sums of the ranks' own
  9. [stepper], the general stepper (``env/core.py``, eager PyTorch) through
     ``random_policy.simulate`` -> ``core.make_batched`` at 4096 boards:
     the flagship (20 invariant-checked steps with PyTorch's sync debug
     mode raising inside each step, the kernel launches of one step from
     ``torch.profiler``, then ``simulate`` warmed up and timed over its 102
     steps), then square, rectangle, rectangle_spatial_pin, the web
     default (2..6 pins per net), and the beam and "both" rewards (20
     checked steps and one ``simulate`` each); every mean return within 4
     combined standard errors of JAX's (tests/fixtures/
     torch_stepper_means.json)
 10. [stepper card == cpu]: 10 steps of the flagship and of "both" at 512
     boards, each replayed on the CPU from the card's state and action:
     integer fields, masks, grids, done and observations equal, rewards and
     info within 1e-5
 11. [reset -> kernel]: ``fused_rollout.init_leaves`` on the card (flagship,
     web default), one chunk of the kernel held to its plain version from
     the same leaves, as in phase 5
 12. the entry point ``graft_entry.dryrun_multigpu(2)``: one sharded PPO
     train step (metrics finite, the same on both ranks), then the fused
     rollout from reset boards
 13. [policy]: the flagship model (tests/fixtures/torch_policy_flagship.npz:
     Flax weights, 64 JAX observations, JAX's outputs) on the card: logits
     and value within 1e-4 relative of JAX's and the CPU's (cuDNN's TF32
     off for the whole run), greedy actions JAX's where its top two logits
     are further apart; the forward's ms at 4096 boards (CUDA events) and
     its launches (``torch.profiler``)
 14. [policy rollout], this slice's main path: that policy sampling on
     4096 flagship boards through ``pooled.rollout_chunk`` (50-step chunks,
     pool ``default_pool_size``, route budget 1024), warmed up and timed;
     wraps 0, 5-step episodes, mean return within 4 combined standard
     errors of JAX's; launches, busy and idle share of a step; the step's
     parts profiled one by one
 15. [pooled]: the random policy through the same engine (``bench.py``'s
     pooled phase), its mean return held to JAX ``simulate``'s; gated ==
     ungated routing on the card (crossings exact, wirelength and reward
     within one f32 ulp) through the none, compacted and full branches
 16. [matrix] web_max_pooled through ``bench_matrix.measure_pooled``: rate,
     wraps (0), mean episode reward
 17. [entry point] ``graft_entry.entry()``: shapes, finite outputs
 18. [learner]: the carried flagship on a minibatch of 128 transitions of a
     CPU rollout: loss, aux and every gradient on the card and on the CPU
     (TF32 off) within 1e-4; one ``update`` (2 epochs, 16 Adam steps) fed
     the same window and permutations: parameters and batch statistics
     within 1e-4 of the CPU's (the biases that feed a batch norm, whose
     gradient is rounding noise, within 2 * lr a step)
 19. [zoo learner]: every other preset of the zoo at its published
     widths, weights drawn from torch seed 0: on 128 transitions of a CPU
     rollout the loss, aux and every gradient on the card and the CPU
     within 1e-4 of the tensor's scale (the factorized presets with
     ``kl_coeff`` = ``entropy_coeff`` = 0); one ``Trainer`` iteration on
     the card (128 x 32, 2 epochs): metrics finite, parameters moved, 0
     wraps; its seconds and peak memory
 20. [train], this slice's main path: ``Trainer("rectangle_pin")``, default
     ``PPOConfig`` (4096 transitions, 960 Adam steps an iteration), carried
     weights, deterministic algorithms (``_deterministic``), 3 iterations
     into a temporary results root: metrics finite,
     parameters moved, 0 pool wraps, progress.csv with JAX's columns,
     params.json, 3 checkpoints; iteration 1's mean return within 4
     combined standard errors of JAX's pooled rollout (the fixture); a
     restore and 1 more iteration (number 4); ``generate_rollouts``; seconds
     an iteration split into rollout and update, env-steps/s, Adam
     steps/s, one minibatch step's launches and busy share, peak memory
 21. [train learns]: tests/agent/test_ppo.py:174-193 on the card (6x6
     square, 40 iterations): the last 5 beat the first 5 by more than 1.0
     and exceed 7.5
 22. [learning curve]: the learning-curve runners' training
     (``experiments/seed_sweep._train_once``) on the spatial flagship,
     seed 0, 128 boards x 32 steps, 10 epochs, 30 iterations: the random
     baseline (512 episodes, seed 1001) within 4 combined standard errors
     of JAX ``simulate``'s, every reward finite, iterations 10, 20 and 30
     inside JAX's committed 10-epoch seed band widened by 0.10
     (experiments/results/rectangle_spatial_pin_seed_sweep_sgd10.csv);
     seconds an iteration
 23. [train dp]: world 1's iteration 1 again, bitwise [train]'s; then
     [train]'s setup over ranks (``parallel/mesh.py``'s learner half
     through ``Trainer(mesh=...)``), deterministic as [train]: ``min(4,
     cards)`` ranks over NCCL with 2 or more cards, else 2 ranks sharing
     the card over gloo; 2 iterations: iteration 1's six metrics of JAX's sharded test
     within rtol 2e-3, atol 1e-5 of [train]'s (every metric's pair and
     its ratio to the allowance printed), the parameters bitwise equal
     across the ranks, 0 wraps; seconds an iteration (rollout, update) on
     each rank, env-steps/s in all and per card against [train]'s, the
     collectives of one minibatch step (``torch.profiler``, rank 0), peak
     memory a rank
 24. [zoo edges]: the model zoo's two repaired settings
     (tests/fixtures/torch_zoo_edges.npz: Flax weights, 64 JAX
     observations, JAX's outputs): the flagship with 3 conv blocks of
     kernel 5 (the grid encoder's map empties) and the spatial preset with
     a max-pooled component grid; eval logits and value within 1e-4
     relative of the CPU's, one train-mode ``evaluate``: finite outputs,
     NaN statistics exactly where the CPU has them
 25. [runners]: the three random-policy runners' ``run()`` at 1024
     episodes (square, rectangular, pin, pin --spatial), each mean return
     within 4 combined standard errors of JAX's; env-steps/s
 26. [profiles]: ``tools/train_profile`` (flagship, 1 / 10 / 30 epochs,
     the rollout's pieces, one minibatch step profiled),
     ``tools/pooled_profile`` (the web app's maximum, 4096 boards, pool 4)
     and ``tools/price_exact_sampling`` (flagship and web-app maximum, 1024
     boards), each at the JAX tool's sizes, writing its JSON (the card's
     name and power limit, ``reduced``) into a temporary directory
 27. [webapp]: ``webapp/data.py``'s ``list_runs``, ``load_run`` and
     ``comparison_curves`` over [train]'s run: its iterations, last mean
     return and every logged value of the curves

Every timed window follows at least ``WARM_S`` seconds of chained launches:
a card fresh from idle runs its first ~50 ms slower while its clock ramps.

Two measurements are not part of the run and are called alone:
``phase_split`` (where a chunk of each kernel goes, from clock64() stamps
in an instrumented copy of the sources) and ``phase_turns`` (another
checkout's kernel sources against this one's, leaves equal, timed in
turns).

The second-to-last line is the kernels' JSON record, each with its bound
(``portbench.workmodel.chunk_bound``, the benchmark's work model); the last
line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import hashlib
import json
import os
import pathlib
import re
import shutil
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
#: [envelope]: the configurations of the JAX kernel's envelope that only the
#: general instantiations take (tests/test_torch_fused_envelope.py), each
#: with its JAX golden (16 boards, block 8, two chained 20-step chunks)
ENVELOPE_EDGES = ("web_nets10", "nets24_both", "ppn24_beam4", "ppn48_beam2",
                  "wide_rect", "tall_square", "wide_square", "wide_pin",
                  "web_nets10_both")
ENVELOPE_BLOCK = 128
#: the edges timed under each routing reward: what the general beam route
#: costs beside the rest of a chunk
SPLIT_EDGES = ("nets24_both", "ppn24_beam4", "ppn48_beam2",
               "web_nets10_both")
#: the edge whose numbers stand for each general instantiation in the
#: kernels' line (the others are printed in [envelope]'s lines)
GENERAL_ROWS = {"centroid": "web_nets10", "beam": "ppn24_beam4",
                "both": "nets24_both", "square": "tall_square",
                "rect": "wide_rect"}
#: the boards one SM must hold at once in each general pin instantiation:
#: 32, so that 4,096 boards are resident at once on 132 SMs
GENERAL_BOARDS_PER_SM = 32
#: main path 3's ranks: chained seeds
RANK_SEEDS = (1, 2)
#: the kernels (one warp per board; 8 boards per CUDA block, the reduced
#: kernels 4) at a batch that leaves a partial CUDA block, and its logical
#: block
PARTIAL_BATCH, PARTIAL_BLOCK = 1004, 4
#: the matrix rows held to plain at that batch: one per kernel
PARTIAL_ROWS = ("pin_centroid", "pin_beam", "pin_both", "square", "rect")
#: boards at which the centroid, beam and rect kernels, and the general
#: ones on four edges, are timed for their scaling
SCALING_BATCHES = (1024, 4096, 16384)
SCALING_EDGES = ("web_nets10", "wide_rect", "tall_square", "wide_square")
#: the reduced kernels' capacity shapes, held to plain at this batch: row,
#: overrides. SQUARE's footprint is (component_n, component_n), not the
#: component ranges; RECT's 64 components fill the second lane slot of the
#: component tables, on a grid where the cursor passes 32; 32 rows fill
#: every lane.
SHAPE_BATCH = 512
REDUCED_SHAPES = {
    "square n=3": ("square", {"component_n": 3}),
    "rect 64 components 32x32": ("rect", {
        "height": 32, "width": 32, "min_num_components": 40,
        "max_num_components": 64}),
    "square 32x32 n=5": ("square", {"height": 32, "width": 32,
                                    "component_n": 5}),
}
#: device cycles the card spins before a timed window, so that the host
#: enqueues the window's launches ahead of it (tried in turn)
SPIN_CYCLES = (10**7, 4 * 10**7, 16 * 10**7)
#: seconds of chained launches before every timed window
WARM_S = 0.5
#: kernel sources, by specialisation
SOURCES = {k: "placement_tpu_torch/ops/csrc/fused_rollout_warp.cu"
           for k in ("centroid", "beam", "both")}
SOURCES.update({k: "placement_tpu_torch/ops/csrc/fused_rollout.cu"
                for k in ("square", "rect")})


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
    # cuBLAS reads it when CUDA starts; ``_deterministic`` needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; the port's smoke run "
                           "needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(_card(), flush=True)
    return name


def _card():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_build():
    """Builds the kernels; prints ``ptxas -v`` of every instantiation, and
    each pin instantiation's registers, stack frame, spill stores and the
    boards one SM holds at once, which must be ``GENERAL_BOARDS_PER_SM``
    or more in the general ones."""
    import torch
    from placement_tpu_torch.ops import _build, fused_rollout
    lib, seconds = _build.build()
    fused_rollout.kernel_library()
    print(f"[build] {lib.name}: {seconds:.1f} s of nvcc")
    log = lib.with_suffix(".log")
    label, kernel, usage = "?", None, {}
    for line in (log.read_text().splitlines() if log.exists() else []):
        m = re.search(r"Compiling entry function '.*fused_rollout_"
                      r"(warp|reduced)_kernelILi(\d)EL[bi]([012])E", line)
        if m:
            kernel = (fused_rollout.KERNELS[int(m.group(2))]
                      + ("", "_general", "_wide")[int(m.group(3))])
            label = f"{kernel} (fused_rollout_{m.group(1)}_kernel)"
        elif "registers" in line or "spill" in line or "stack frame" in line:
            print(f"[build] {label}: {line.strip()}")
            got = usage.setdefault(kernel, {})
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores", line)
            if m and "stack" not in got:
                got["stack"], got["spill"] = int(m[1]), int(m[2])
            m = re.search(r"Used (\d+) registers", line)
            if m and "regs" not in got:
                got["regs"] = int(m[1])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pins = [(k, tier, _row(KERNELS[k][0])[0])
            for k in ("centroid", "beam", "both")
            for tier in ("default", "general")]
    web_max = _row("web_max_pooled")[0]
    pins += [("centroid", "wide", web_max)] + [
        (k, "wide", web_max.replace(reward_type=k, reward_beam_width=4))
        for k in ("beam", "both")]
    for k, tier, params in pins:
        name = k if tier == "default" else f"{k}_{tier}"
        got = usage.get(name, {})
        now = fused_rollout.boards_per_sm(params, tier)
        print(f"[build] {name}: {got.get('regs')} registers, "
              f"{got.get('stack')} B stack frame, {got.get('spill')} B spill "
              f"stores; {now} boards resident per SM, {now * sms} on {sms} "
              "SMs")
        if tier == "general":
            _check(now >= GENERAL_BOARDS_PER_SM,
                   f"{name}: {now} boards resident per SM, under "
                   f"{GENERAL_BOARDS_PER_SM}")


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


def phase_jax_golden(name, fixture=None):
    from placement_tpu_torch.ops import fused_rollout as fr
    want = json.loads((FIXTURES / (fixture or JAX_GOLDENS[name])).read_text())
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
    warm-up. The card first spins while the host enqueues all n launches:
    a kernel shorter than the wrapper's enqueue would otherwise be timed at
    the host's pace. The window counts only if the card had not reached
    its start when the last launch was enqueued."""
    import torch
    _warm(fn, leaves)
    for cycles in SPIN_CYCLES:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        out = leaves
        for i in range(n):
            out, _, _ = fn.per_board(out, seed + i)
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / n
    raise RuntimeError("chip_smoke: the host never enqueued a timed window "
                       "ahead of the card")


def _plain_ms(params, leaves, seed, block):
    import torch
    from placement_tpu_torch.ops import fused_rollout as fr
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fr.rollout_chunk_reference(params, leaves, seed, STEPS, block)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_kernel_vs_plain(label, params, block, batch=BATCH, timed=True,
                          plain_turns=True):
    """The kernel against its plain version on ``params`` at ``batch``
    boards and logical ``block``, two chained chunks; returns (max abs
    error, kernel ms per chunk, plain ms per chunk, bound ms, bound_by),
    the error alone when not ``timed``. Without ``plain_turns`` the plain
    version's time is that of the compared chunks (for a plain version of
    tens of seconds a chunk), not of two more in turns with the kernel."""
    import torch
    from placement_tpu_torch.ops import fused_rollout as fr
    from portbench import workmodel
    label += f" ({fr.kernel_name(params)} kernel)"
    fn = fr.make_fused_rollout(params, batch, STEPS, block=block,
                               device="cuda")
    leaves = fr.zero_leaves(params, batch, "cuda")
    leaf_err = board_err = 0.0
    compared_ms = []
    for seed in (1, 2):        # from zero boards, then from mid-run boards
        got, got_r, got_d = fn.per_board(leaves, seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, want_r, want_d = fr.rollout_chunk_reference(
            params, leaves, seed, STEPS, block)
        torch.cuda.synchronize()
        compared_ms.append((time.perf_counter() - t0) * 1e3)
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
    if not timed:
        return (err,)
    # the bound of the second chunk (from mid-run boards) on its own data
    bound_ms, bound_by, ops, nbytes = workmodel.chunk_bound(
        params, batch, STEPS, int(got_d.sum()), leaves)
    # in turns: plain, kernel, kernel, plain
    plain = [_plain_ms(params, leaves, 3, block)] if plain_turns else []
    kernel_ms = [_kernel_ms(fn, leaves, 10, TIMED_CHUNKS),
                 _kernel_ms(fn, leaves, 100, TIMED_CHUNKS)]
    plain.append(_plain_ms(params, leaves, 4, block) if plain_turns
                 else compared_ms[1])
    print(f"[kernel vs plain] {label}: ms per {STEPS}-step chunk: kernel "
          f"{kernel_ms!r}, plain {plain!r}; bound {bound_ms!r} ms by "
          f"{bound_by} ({ops!r} operations, {nbytes} bytes); share of "
          f"bound (bound / kernel ms) {bound_ms / min(kernel_ms)!r}")
    return err, min(kernel_ms), min(plain), bound_ms, bound_by


def phase_envelope():
    """[envelope]: each edge of the JAX kernel's envelope, which only the
    general instantiations take: the kernel's leaf hashes equal to the JAX
    kernel's recorded ones at the fixture's size; kernel == plain at
    ``BATCH`` boards, two chained chunks, timed; then the matrix tool's
    fused row on it (``bench_matrix.measure``, the user's entry point),
    whose launches count; ``SPLIT_EDGES`` timed under each routing reward.
    Then three default rows on the general instantiation: their time
    beside the default one's, leaves equal.
    Returns name -> (kernel, err, ms, plain ms, bound ms, bound_by,
    launches)."""
    import torch
    from placement_tpu_torch.ops import fused_rollout as fr
    from placement_tpu_torch.tools import bench_matrix as bm
    out = {}
    for name in ENVELOPE_EDGES:
        want = phase_jax_golden(name, f"torch_fused_zero_envelope_{name}.json")
        params = _golden_params(want)
        _check(fr.needs_general(params), f"{name}: not a general config")
        got = phase_kernel_vs_plain(f"envelope {name}", params,
                                    ENVELOPE_BLOCK, plain_turns=False)
        row, _ = bm.measure(name, params, "envelope edge", BATCH,
                            device="cuda", block=ENVELOPE_BLOCK)
        print(f"[envelope] {name} ({row['kernel']} kernel, general "
              f"instantiation): {BATCH} boards, block {ENVELOPE_BLOCK}: "
              f"kernel {got[1]!r} ms per chunk, plain {got[2]!r} "
              f"ms, bound {got[3]!r} ms by {got[4]}; bench_matrix.measure "
              f"{row['steps_per_sec']!r} env-steps/s, {row['launches']} "
              f"launches for {row['calls']} calls, {row['episodes']} "
              f"episodes")
        _check(row["launches"] == row["calls"], f"{name}: matrix row "
                                                "missed the kernel")
        out[name] = (row["kernel"], *got, row["launches"])
        if name in SPLIT_EDGES:
            phase_reward_split(f"envelope {name}", params, ENVELOPE_BLOCK)
        if name in SCALING_EDGES:
            phase_batch_scaling(params, ENVELOPE_BLOCK)
    # what the default instantiation saves where both run: the flagship's
    # rows on the general one, leaves equal to the default one's
    for row in ("pin_centroid", "pin_beam", "rect"):
        params, block = _row(row)
        ms = {}
        for tier in ("default", "general"):
            fn = fr.make_fused_rollout(params, BATCH, STEPS, block=block,
                                       device="cuda")
            fn._kparams.tier = fr.TIERS.index(tier)
            leaves = fr.zero_leaves(params, BATCH, "cuda")
            for seed in (1, 2):
                leaves, _, _ = fn.per_board(leaves, seed)
            ms[tier] = (_kernel_ms(fn, leaves, 10, TIMED_CHUNKS), leaves)
        (dms, dleaves), (gms, gleaves) = ms["default"], ms["general"]
        same = all(torch.equal(dleaves[k], gleaves[k]) for k in fr._LEAVES)
        print(f"[envelope] {row} on the general instantiation: {gms!r} ms "
              f"per chunk, the default one {dms!r} ms ({gms / dms!r} x); "
              f"leaves equal {same}")
        _check(same, f"{row}: the general instantiation's leaves differ")
    return out


#: [wide]: the steps of the chunk held to the plain version on the web
#: app's largest boards (its generator, at 40 components, takes about a
#: second a step at 4096 boards), after chunks that leave the boards
#: mid-episode
WIDE_CHECK_STEPS = 10


def phase_wide():
    """[wide] web_max (bench_matrix's ``web_max_pooled`` configuration, the
    web app's largest boards) on the wide instantiation of the centroid
    kernel, at ``BATCH`` boards and the benchmark cell's block: the kernel
    against the plain version on a ``WIDE_CHECK_STEPS``-step chunk from
    mid-run boards (leaves and done counts equal, board rewards within
    5e-4); the kernel's ms per ``STEPS``-step chunk and its bound; then
    ``bench_matrix.measure``'s row. Returns (err, ms, plain ms, bound ms,
    bound_by, launches)."""
    import torch
    from placement_tpu_torch.ops import fused_rollout as fr
    from placement_tpu_torch.tools import bench_matrix as bm
    from portbench import workmodel
    params = _row("web_max_pooled")[0]
    _check(fr.kernel_tier(params) == "wide", "web_max: not the wide tier")
    fn = fr.make_fused_rollout(params, BATCH, STEPS, block=BLOCK,
                               device="cuda")
    leaves = fr.zero_leaves(params, BATCH, "cuda")
    for seed in (1, 2, 3):
        leaves, _, _ = fn.per_board(leaves, seed)
    short = fr.make_fused_rollout(params, BATCH, WIDE_CHECK_STEPS,
                                  block=BLOCK, device="cuda")
    got, got_r, got_d = short.per_board(leaves, 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, want_r, want_d = fr.rollout_chunk_reference(
        params, leaves, 4, WIDE_CHECK_STEPS, BLOCK)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bad = [k for k in fr._LEAVES if not torch.equal(got[k], want[k])]
    err = float((got_r - want_r).abs().max())
    print(f"[wide] web_max: {BATCH} boards, block {BLOCK}, "
          f"{WIDE_CHECK_STEPS} steps from mid-run boards: leaves differing "
          f"{bad}, done counts equal {torch.equal(got_d, want_d)}, max "
          f"|board reward diff| {err!r}, {int(got_d.sum())} episodes; the "
          f"plain version {plain_ms!r} ms", flush=True)
    _check(not bad, f"web_max: kernel leaves differ from the plain "
                    f"version: {bad}")
    _check(torch.equal(got_d, want_d), "web_max: done counts differ")
    # the centroid route's terms are added in another order
    _check(err <= 5e-4, "web_max: board rewards differ")
    leaves, _, dcnt = fn.per_board(got, 5)
    ms = _kernel_ms(fn, leaves, 10, TIMED_CHUNKS)
    bound_ms, bound_by, ops, nbytes = workmodel.chunk_bound(
        params, BATCH, STEPS, int(dcnt.sum()), leaves)
    row, _ = bm.measure("web_max", params, "web app maximum", BATCH,
                        device="cuda", block=BLOCK)
    print(f"[wide] web_max: kernel {ms!r} ms per {STEPS}-step chunk, "
          f"{BATCH * STEPS / ms * 1e3!r} env-steps/s; bound {bound_ms!r} "
          f"ms by {bound_by} ({ops!r} operations, {nbytes} bytes), share "
          f"{bound_ms / ms!r}; bench_matrix.measure "
          f"{row['steps_per_sec']!r} env-steps/s, {row['launches']} "
          f"launches for {row['calls']} calls, {row['episodes']} episodes",
          flush=True)
    _check(row["launches"] == row["calls"], "web_max: matrix row missed "
                                            "the kernel")
    return err, ms, plain_ms, bound_ms, bound_by, row["launches"]


#: [wide beam]: the logical block of rows 2w and 3w, the web_max.beam
#: cell's
WIDE_BEAM_BLOCK = 128


def _reference_params(params):
    """``params`` as ``portbench/reference.py``'s ``Params``."""
    import dataclasses
    from portbench import reference
    return reference.Params(**{
        f.name: getattr(params, f.name)
        for f in dataclasses.fields(reference.Params)
        if f.name != "variant"}, variant=reference.Variant(
            int(params.variant)))


def _wide_beam_rows():
    """label -> params of [wide beam]'s rows: web_max (bench_matrix's
    ``web_max_pooled``) under the beam reward at width 4 and "both" at
    widths 2 and 4."""
    params = _row("web_max_pooled")[0]
    return {f"{k}{bw}": params.replace(reward_type=k, reward_beam_width=bw)
            for k, bw in (("beam", 4), ("both", 2), ("both", 4))}


def phase_wide_beam():
    """[wide beam] rows 2w and 3w: web_max on the wide instantiations of
    the beam and "both" kernels at ``BATCH`` boards, logical block
    ``WIDE_BEAM_BLOCK``: three chained chunks from zero boards, each held
    to ``portbench/reference_wide_beam.py`` (leaves and done counts equal;
    beam rewards equal, "both" rewards within 5e-4, where the centroid
    route's terms are added in another order); then the kernel's ms per
    chunk and its bound, beside the centroid kernel's on the same boards.
    Returns label -> (err, ms, reference ms, bound ms, bound_by,
    launches)."""
    import torch
    from placement_tpu_torch.ops import fused_rollout as fr
    from portbench import reference_wide_beam, workmodel
    out = {}
    for label, params in _wide_beam_rows().items():
        _check(fr.kernel_tier(params) == "wide", f"{label}: not the wide "
                                                 "tier")
        ref = _reference_params(params)
        fn = fr.make_fused_rollout(params, BATCH, STEPS,
                                   block=WIDE_BEAM_BLOCK, device="cuda")
        leaves = fr.zero_leaves(params, BATCH, "cuda")
        err, ref_ms = 0.0, []
        for seed in (1, 2, 3):
            got, got_r, got_d = fn.per_board(leaves, seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want, want_r, want_d = reference_wide_beam.rollout_chunk(
                ref, leaves, seed, STEPS, WIDE_BEAM_BLOCK)
            torch.cuda.synchronize()
            ref_ms.append((time.perf_counter() - t0) * 1e3)
            bad = [k for k in fr._LEAVES if not torch.equal(got[k], want[k])]
            gap = float((got_r - want_r).abs().max())
            err = max(err, gap)
            print(f"[wide beam] web_max {label}: {BATCH} boards, block "
                  f"{WIDE_BEAM_BLOCK}, seed {seed}: leaves differing {bad}, "
                  f"done counts equal {torch.equal(got_d, want_d)}, max "
                  f"|board reward diff| {gap!r}, {int(got_d.sum())} "
                  f"episodes; reference_wide_beam {ref_ms[-1]!r} ms",
                  flush=True)
            _check(not bad, f"web_max {label}: kernel leaves differ from "
                            f"the reference: {bad}")
            _check(torch.equal(got_d, want_d),
                   f"web_max {label}: done counts differ")
            _check(gap == 0.0 if params.reward_type == "beam" else
                   gap <= 5e-4, f"web_max {label}: board rewards differ")
            leaves = got
        ms = _kernel_ms(fn, leaves, 10, TIMED_CHUNKS)
        centroid = fr.make_fused_rollout(params.replace(
            reward_type="centroid"), BATCH, STEPS, block=WIDE_BEAM_BLOCK,
            device="cuda")
        c_ms = _kernel_ms(centroid, leaves, 10, TIMED_CHUNKS)
        bound_ms, bound_by, ops, nbytes = workmodel.chunk_bound(
            ref, BATCH, STEPS, int(got_d.sum()), leaves)
        print(f"[wide beam] web_max {label}: kernel {ms!r} ms per {STEPS}-"
              f"step chunk ({fn.kernel} kernel, {fn.tier} instantiation), "
              f"{BATCH * STEPS / ms * 1e3!r} env-steps/s; the centroid "
              f"kernel on the same boards {c_ms!r} ms; bound {bound_ms!r} "
              f"ms by {bound_by} ({ops!r} operations, {nbytes} bytes), "
              f"share {bound_ms / ms!r}", flush=True)
        out[label] = (err, ms, min(ref_ms), bound_ms, bound_by,
                      fn.launches)
    return out


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
        print(f"[batch] {fn.kernel} kernel"
              f"{'' if fn.tier == 'default' else f' ({fn.tier})'}, "
              f"{batch} boards: ms per chunk {ms!r}, "
              f"{batch * STEPS / min(ms) * 1e3!r} "
              "env-steps/s")


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


# ---- where a chunk goes, and two kernel sources in turns (run alone) -------
#
# Neither is part of the smoke run:
#   python -c "import chip_smoke as cs; cs.phase_device(); cs.phase_split()"
#   python -c "import chip_smoke as cs; cs.phase_device();
#              cs.phase_turns('<parent checkout>')"

#: a board-step's phases in the instrumented copy of the kernel sources:
#: the pin kernels' and the reduced kernels' names for the counter slots
#: (slot 7 is the whole loop over the chunk's steps; "crossings", the beam
#: route's crossing count, is a part of "route"). Slots 9-11 count the
#: crossing counts that run (boards of two nets or more), their routed
#: segments V and the pair passes dealt a lane, ceil(V (V - 1) / 64); slot
#: 12 the per-net allocations (allocate_net's calls, or allocate_net_wide's).
#: Slots 13-19 split beam_nets (the general and wide beam routes, every
#: layout; parts of "route", ROUTE_PARTS), slot 20 counts its search rounds
#: and slot 21 those whose candidates are found by rank counts.
SPLIT_PHASES = {
    "pin": ("sample", "paint and pins", "planes", "route",
            "generator (not allocate_net)", "allocate_net", "crossings"),
    "reduced": ("sample (nth_cell)", "paint", "planes", None, "generator"),
}
ROUTE_PARTS = ("start", "keys", "candidate search", "costs", "keep-best",
               "update", "wirelength")
#: [envelope]'s edges (and the default rows) that phase_split and
#: phase_turns run; "<edge>/<reward>" runs an edge under another reward
PHASE_ROWS = ("web_nets10", "nets24_both/centroid", "nets24_both",
              "wide_pin", "web_nets10_both", "ppn24_beam4", "ppn48_beam2",
              "wide_rect", "tall_square", "wide_square", "pin_centroid",
              "pin_beam", "pin_both", "rect", "square", "varpin_web",
              "pin_centroid/general", "pin_beam/general", "rect/general",
              "web_max", "varpin_parity", "web_max_beam")

#: the counter slots of the instrumented copy (_PROF's PHASE_SLOTS)
PHASE_SLOTS = 22
_PROF = r"""
#define PHASE_SLOTS @
__shared__ unsigned long long s_phase_clocks[8][PHASE_SLOTS];
__device__ unsigned long long g_phase_clocks[PHASE_SLOTS];
#define PHASE_ADD(i, t0) do { long long now_ = clock64(); \
  if ((threadIdx.x & 31) == 0) s_phase_clocks[threadIdx.x >> 5][i] += \
      now_ - (t0); t0 = now_; } while (0)
#define PHASE_COUNT(i, v) do { if ((threadIdx.x & 31) == 0) \
  s_phase_clocks[threadIdx.x >> 5][i] += (v); } while (0)
extern "C" int PHASE_READER(unsigned long long* host) {
  cudaMemcpyFromSymbol(host, g_phase_clocks, sizeof(g_phase_clocks));
  unsigned long long zero[PHASE_SLOTS] = {0};
  cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero));
  return (int)cudaDeviceSynchronize();
}
""".replace("@", str(PHASE_SLOTS))
_LOOP = ("  float rsum = 0.0f;\n  int dcnt = 0;\n"
         "  for (int t = 0; t < num_steps; ++t) {\n")
_LOOP_PROF = ("  float rsum = 0.0f;\n  int dcnt = 0;\n"
              "  if (lane == 0)\n"
              "    for (int i = 0; i < PHASE_SLOTS; ++i)\n"
              "      s_phase_clocks[warp][i] = 0;\n"
              "  long long t_loop = clock64();\n"
              "  for (int t = 0; t < num_steps; ++t) {\n")
_FLUSH = ("  PHASE_ADD(7, t_loop);\n  if (lane == 0) {\n"
          "    for (int i = 0; i < PHASE_SLOTS; ++i)\n"
          "      atomicAdd(&g_phase_clocks[i],\n"
          "                i == 8 ? 1ull : s_phase_clocks[warp][i]);\n"
          "  }\n")
#: the beam route's crossing count (fused_rollout_warp.cu::beam_crossings):
#: its cycles, nested in the route's, and its counters
_CROSSINGS = (
    ("fused_rollout_warp.cu", "  __syncwarp();  // the route's writes are "
     "done\n", "", "  long long tc_ = clock64();\n"),
    ("fused_rollout_warp.cu", "  if (apart) {\n", "  PHASE_COUNT(9, 1);\n"
     "  PHASE_COUNT(10, V);\n  PHASE_COUNT(11, apart ? (V * (V - 1) / 2 + 31) "
     "/ 32 : 0);\n", ""),
    ("fused_rollout_warp.cu", "  return warp_sum(ints);\n}",
     "  PHASE_ADD(6, tc_);\n", ""),
)
#: beam_nets' parts (ROUTE_PARTS: slots 13-19), its rounds (slot 20) and the
#: rounds whose candidate search counts ranks (slot 21; a source without
#: that search has no such anchor: _OPTIONAL)
RANK_SEARCH = "      uint32_t below[2][MAX_BW] = {};\n"
_ROUTE = (
    ("fused_rollout_warp.cu", "  const int M = p.pins_per_net, bw = "
     "p.beam_width;\n  // lanes a segment", "  long long tr_ = clock64();\n",
     ""),
    ("fused_rollout_warp.cu", "  for (int step = 0; step < rounds; ++step) {\n"
     "    const bool active[2] = {step + 1 <= lim[0] - 1, step + 1 <= lim[1] "
     "- 1};\n", "  PHASE_ADD(13, tr_);\n", "    PHASE_COUNT(20, 1);\n"),
    ("fused_rollout_warp.cu", "    uint32_t cn[2] = {0u, 0u};\n",
     "    PHASE_ADD(14, tr_);\n", ""),
    ("fused_rollout_warp.cu", "    float cc[2][MAX_BW];\n",
     "    PHASE_ADD(15, tr_);\n", ""),
    ("fused_rollout_warp.cu", "    uint32_t sel[2][MAX_BW];\n",
     "    PHASE_ADD(16, tr_);\n", ""),
    ("fused_rollout_warp.cu", "        if (active[s]) cost[s][k2] = "
     "__uint_as_float(wh[0][s]);\n      }\n    }\n", "",
     "    PHASE_ADD(17, tr_);\n"),
    ("fused_rollout_warp.cu", "      ranks[s] = nranks;\n    }\n", "",
     "    PHASE_ADD(18, tr_);\n"),
    ("fused_rollout_warp.cu", "  return wl;\n}\n", "  PHASE_ADD(19, tr_);\n",
     ""),
    ("fused_rollout_warp.cu", RANK_SEARCH, "", "      PHASE_COUNT(21, 1);\n"),
)
_OPTIONAL = (RANK_SEARCH,)
#: (file, anchor, text put before it, text put after it)
_STAMPS = (
    ("fused_rollout_warp.cu", '#include "fused_warp.cuh"\n', "",
     _PROF.replace("PHASE_READER", "phase_clocks_pin")),
    ("fused_rollout_warp.cu", "  const int C = p.components, P = p.pins;\n"
     "  // sample a legal action over four planes", "  long long t_ = clock64();\n", ""),
    ("fused_rollout_warp.cu", "  nth_cell<FLAT>(p, even ? b.pl0 : b.pl1, "
     "(int)tin, lane, xx, yy);\n", "", "  PHASE_ADD(0, t_);\n"),
    ("fused_rollout_warp.cu", "  const bool placed_all = b.cur >= b.numc;\n"
     "  planes_for", "  PHASE_ADD(1, t_);\n", ""),
    ("fused_rollout_warp.cu", "  const bool done = placed_all || nt == 0 || "
     "!alive;\n", "", "  PHASE_ADD(2, t_);\n"),
    ("fused_rollout_warp.cu", "                            : p.penalty;\n", "",
     "  PHASE_ADD(3, t_);\n"),
    ("fused_rollout_warp.cu", "  const int PPC = p.pins_per_component;\n", "",
     "  long long tg_ = clock64();\n"),
    ("fused_rollout_warp.cu", "  __syncwarp();  // the last episode's reads "
     "of the tables are done\n", "", "  PHASE_ADD(4, tg_);\n"),
    ("fused_rollout_warp.cu", "  for (int n = 0; n < N; ++n) {  // draws "
     "call_base .. call_base+N-1\n", "", "    PHASE_COUNT(12, 1);\n"),
    ("fused_rollout_warp.cu", "  // draw call_base+N: a random cell order per "
     "component", "  PHASE_ADD(5, tg_);\n", ""),
    ("fused_rollout_warp.cu", "  b.grid = 0u;\n  b.cur = 0;\n  planes_for",
     "  PHASE_ADD(4, tg_);\n", ""),
    ("fused_rollout_warp.cu", "                      __shfl_sync(FULL, "
     "b.cw[0], 0), true, lane);\n}", "", ""),
    ("fused_rollout_warp.cu", _LOOP + "    rng.salt = step_salt(blk_salt, t);"
     "\n    if constexpr (TIER == T_WIDE)", "", ""),
    ("fused_rollout_warp.cu", "  store_rows<FLAT>(p, out.grid + b * A, "
     "bd.grid, lane);\n", _FLUSH, ""),
    *_CROSSINGS,
    *_ROUTE,
    ("fused_rollout.cu", '#include "fused_warp.cuh"\n', "",
     _PROF.replace("PHASE_READER", "phase_clocks_reduced")),
    ("fused_rollout.cu", "  const int c0 = b.n0, c1 = K == K_SQUARE ? 0 : "
     "b.n1;\n", "  long long t_ = clock64();\n", ""),
    ("fused_rollout.cu", "    nth_cell<FLAT>(p, odd ? b.pl1 : b.pl0, (int)tin,"
     " lane, xx, yy);\n", "", "    PHASE_ADD(0, t_);\n"),
    ("fused_rollout.cu", "    paint<FLAT>(p, b.grid, xx, yy, odd ? b.w : b.h,"
     " odd ? b.h : b.w, lane);\n", "", "    PHASE_ADD(1, t_);\n"),
    ("fused_rollout.cu", "  next_component<K, FLAT>(p, b, placed_all, lane);"
     "\n", "", "  PHASE_ADD(2, t_);\n"),
    ("fused_rollout.cu", "  const int C = p.components;\n  if (K == K_SQUARE)"
     " {", "  long long tg_ = clock64();\n", ""),
    ("fused_rollout.cu", "  next_component<K, FLAT>(p, b, false, lane);\n",
     "  PHASE_ADD(4, tg_);\n", "  PHASE_ADD(2, tg_);\n"),
    ("fused_rollout.cu", _LOOP + "    rng.salt = step_salt(blk_salt, t);\n"
     "    step<K, FLAT>", "", ""),
    ("fused_rollout.cu", "  store_rows<FLAT>(p, out.grid + b * A, bd.grid, "
     "lane);\n", _FLUSH, ""),
    # the general square kernel (four boards a warp: its cycles are a
    # warp's, counted once a warp)
    ("fused_rollout.cu", "  // sample the k-th legal anchor:",
     "  long long t_ = clock64();\n", ""),
    ("fused_rollout.cu", "  if (FIRST || WHOLE) flat_rowcol(p, t, xx, yy);\n",
     "", "  PHASE_ADD(0, t_);\n"),
    ("fused_rollout.cu", "  b.rsum = b.rsum + (alive ? 1.0f : 0.0f);\n", "",
     "  PHASE_ADD(1, t_);\n"),
    ("fused_rollout.cu", "  const bool done = placed_all || empty || !alive;"
     "\n", "", "  PHASE_ADD(2, t_);\n"),
    ("fused_rollout.cu", "  b.fresh = b.fresh || done;\n", "",
     "  PHASE_ADD(4, t_);\n"),
    ("fused_rollout.cu", "  if (num_steps > 0) {\n    rng.salt = step_salt("
     "blk_salt, 0);\n", "  if (lane == 0)\n    for (int i = 0; i < "
     "PHASE_SLOTS; ++i) s_phase_clocks[threadIdx.x >> 5][i] = 0;\n"
     "  long long t_loop = clock64();\n", ""),
    ("fused_rollout.cu", "anchors, sl, lane, words, 0, 0, bd);\n  }\n", "",
     _FLUSH.replace("[warp]", "[threadIdx.x >> 5]")),
)


def _instrument(src, dst):
    """A copy of the kernel sources in ``src`` with clock64() stamps: each
    warp's lane 0 sums its board's cycles per phase (``SPLIT_PHASES``) in
    shared memory and adds them to a device counter at the chunk's end."""
    dst.mkdir(parents=True, exist_ok=True)
    texts = {f.name: f.read_text() for f in src.iterdir()
             if f.suffix in (".cu", ".cuh")}
    for name, anchor, before, after in _STAMPS:
        text = texts[name]
        if anchor in _OPTIONAL and anchor not in text:
            continue
        _check(text.count(anchor) == 1, f"phase stamps: {name} has "
                                        f"{text.count(anchor)} of {anchor!r}")
        new = before + anchor + after
        if anchor.startswith(_LOOP):
            new = anchor.replace(_LOOP, _LOOP_PROF)
        elif anchor.endswith("true, lane);\n}"):
            new = anchor[:-2] + "\n  PHASE_ADD(2, tg_);\n}"
        texts[name] = text.replace(anchor, new)
    for name, text in texts.items():
        (dst / name).write_text(text)


@contextlib.contextmanager
def _library(lib):
    """The fused wrapper launches ``lib`` (a loaded kernel library)."""
    from placement_tpu_torch.ops import fused_rollout as fr
    was = fr.kernel_library
    fr.kernel_library = lambda: lib
    try:
        yield
    finally:
        fr.kernel_library = was


def _phase_row(name):
    """A row of ``PHASE_ROWS``: (label, params, block, the tier it is
    forced onto or None)."""
    base, _, variant = name.partition("/")
    fixture = FIXTURES / f"torch_fused_zero_envelope_{base}.json"
    if fixture.exists():
        params, block = _golden_params(json.loads(fixture.read_text())), \
            ENVELOPE_BLOCK
    elif base in VARPIN:
        params = _golden_params(json.loads(
            (FIXTURES / JAX_GOLDENS[base]).read_text()))
        block = VARPIN[base]
    elif base == "web_max":      # the wide instantiation, at the cell's block
        params, block = _row("web_max_pooled")[0], BLOCK
    elif base == "web_max_beam":  # the wide beam kernel, as web_max.beam
        params, block = _wide_beam_rows()["beam4"], WIDE_BEAM_BLOCK
    else:
        params, block = _row(base)
    if variant in ("centroid", "beam", "both"):
        params = params.replace(reward_type=variant)
    return name, params, block, ("general" if variant == "general" else None)


def _row_fn(params, block, tier):
    from placement_tpu_torch.ops import fused_rollout as fr
    fn = fr.make_fused_rollout(params, BATCH, STEPS, block=block,
                               device="cuda")
    if tier is not None:
        fn._kparams.tier = fr.TIERS.index(tier)
    leaves = fr.zero_leaves(params, BATCH, "cuda")
    for seed in (1, 2):
        leaves, _, _ = fn.per_board(leaves, seed)
    return fn, leaves


def phase_split(rows=PHASE_ROWS, csrc=None):
    """Where a chunk goes: an instrumented copy of the kernel sources
    (``csrc``, by default this checkout's) built into build/kernel_phases/,
    20 chained chunks of each row at ``BATCH`` boards from mid-run boards;
    per row each phase's cycles a board and chunk (summed over its warp's
    steps) and share of the loop's, and the chunk's ms in the instrumented
    and the plain build."""
    import ctypes
    import torch
    from placement_tpu_torch.ops import _build, fused_rollout as fr
    csrc = pathlib.Path(csrc) if csrc else _build.CSRC
    copy = REPO / "build" / "kernel_phases" / "src"
    _instrument(csrc, copy)
    libs = {}
    for tag, src in (("plain", csrc), ("stamped", copy)):
        path, seconds = _build.build(src, REPO / "build" / "kernel_phases")
        libs[tag] = fr.load_kernel_library(path)
        print(f"[split] {tag} build of {src}: {seconds:.1f} s of nvcc")
    for name in rows:
        label, params, block, tier = _phase_row(name)
        kind = "reduced" if fr.kernel_name(params) in ("square", "rect") \
            else "pin"
        reader = getattr(libs["stamped"], f"phase_clocks_{kind}")
        counts = (ctypes.c_ulonglong * PHASE_SLOTS)()
        ms = {}
        for tag in ("plain", "stamped"):
            with _library(libs[tag]):
                fn, leaves = _row_fn(params, block, tier)
                ms[tag] = _kernel_ms(fn, leaves, 10, TIMED_CHUNKS)
                if tag == "stamped":
                    reader(counts)
                    done = 0
                    for i in range(TIMED_CHUNKS):
                        leaves, _, d = fn.per_board(leaves, 1000 + i)
                        done += int(d.sum())
                    torch.cuda.synchronize()
                    _check(reader(counts) == 0, "phase counters")
        boards = counts[8]
        names = SPLIT_PHASES[kind]
        cycles = {n: counts[i] / boards for i, n in enumerate(names) if n}
        loop = counts[7] / boards
        routes = counts[9]
        cross = (f"; crossings {cycles['crossings'] / cycles['route']!r} of "
                 "the route" if cycles.get("route") else "")
        if routes:
            cross += (f"; crossing counts a board and chunk "
                      f"{routes / boards!r}, their mean V "
                      f"{counts[10] / routes!r} and passes dealt a lane "
                      f"{counts[11] / routes!r}")
        if counts[12]:
            cross += (f"; allocations a board and chunk "
                      f"{counts[12] / boards!r}, cycles an allocation "
                      f"{counts[5] / counts[12]!r}")
        cross += _route_split(counts, cycles)
        print(f"[split] {label} ({fn.kernel} kernel, {fn.tier} "
              f"instantiation): ms per chunk "
              f"{ms['plain']!r} (stamped {ms['stamped']!r}); episodes a board "
              f"and chunk {done / BATCH / TIMED_CHUNKS!r}; cycles a board and "
              f"chunk {loop!r}; shares "
              f"{json.dumps({n: c / loop for n, c in cycles.items()})}; "
              f"cycles {json.dumps(cycles)}{cross}", flush=True)


def _route_split(counts, cycles):
    """phase_split's words on beam_nets: its parts' cycles a board and
    chunk and their shares of the route (the crossing count beside them),
    its search rounds a board and chunk, and the share of those searched
    by rank counts (0 where no round ran)."""
    boards, rounds = counts[8], counts[20]
    out = ""
    if rounds:
        parts = {n: counts[13 + i] / boards
                 for i, n in enumerate(ROUTE_PARTS)}
        parts["crossings"] = cycles["crossings"]
        shares = {n: c / cycles["route"] for n, c in parts.items()}
        out = (f"; beam_nets' parts a board and chunk {json.dumps(parts)}, "
               f"shares of the route {json.dumps(shares)}")
    ranked = counts[21] / rounds if rounds else 0.0
    return (f"{out}; search rounds a board and chunk {rounds / boards!r}, "
            f"searched by rank {ranked!r}")


def phase_turns(parent, rows=PHASE_ROWS, this=REPO):
    """The kernel sources of another checkout (``parent``, its root) and
    of ``this`` one (by default this checkout), each built into
    build/kernel_phases/, on each row at ``BATCH`` boards: the same chunk's
    leaves, board sums and done counts equal bit for bit, then ms per chunk
    in turns parent, this, this, parent, and the smaller of each pair."""
    import torch
    from placement_tpu_torch.ops import _build, fused_rollout as fr
    libs = {}
    for tag, root in (("parent", pathlib.Path(parent)),
                      ("this", pathlib.Path(this))):
        src = root / "placement_tpu_torch" / "ops" / "csrc"
        path, seconds = _build.build(src, REPO / "build" / "kernel_phases")
        libs[tag] = fr.load_kernel_library(path)
        print(f"[turns] {tag} build of {src}: {seconds:.1f} s of nvcc; "
              f"{path.name}")
    for name in rows:
        label, params, block, tier = _phase_row(name)
        runs = {}
        for tag in ("parent", "this"):
            with _library(libs[tag]):
                fn, leaves = _row_fn(params, block, tier)
                runs[tag] = (fn, fn.per_board(leaves, 77))
        (fa, (la, ra, da)), (fb, (lb, rb, db)) = runs["parent"], runs["this"]
        same = (all(torch.equal(la[k], lb[k]) for k in fr._LEAVES)
                and torch.equal(ra, rb) and torch.equal(da, db))
        ms = {"parent": [], "this": []}
        for tag in ("parent", "this", "this", "parent"):
            fn = runs[tag][0]
            with _library(libs[tag]):
                ms[tag].append(_kernel_ms(fn, la, 10, TIMED_CHUNKS))
        best = {k: min(v) for k, v in ms.items()}
        print(f"[turns] {label} ({fb.kernel} kernel"
              f"{'' if fb.tier == 'default' else ', ' + fb.tier}): a "
              f"chunk's leaves, board sums and done counts equal {same}; "
              f"ms per chunk "
              f"parent {ms['parent']!r}, this {ms['this']!r}: "
              f"{best['this']!r} against {best['parent']!r} "
              f"({best['this'] / best['parent']!r} x)", flush=True)
        _check(same, f"{label}: this checkout's kernel differs from the "
                     "parent's")


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
    over the rows (each row's wrapper counts from 0), and the rows."""
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
    return launches, rows


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


# ---------------------------------------------------------------------------
# The general stepper (env/core.py) and the random-policy baseline
# ---------------------------------------------------------------------------

#: the [stepper] configs and JAX simulate's numbers for them (recorded by
#: ``PYTHONPATH=. python tests/test_torch_core.py``)
STEPPER_FIXTURE = FIXTURES / "torch_stepper_means.json"
#: steps of the invariant-checked loop of each config; standard errors the
#: mean return may sit from JAX's
STEPPER_STEPS, STEPPER_SE = 20, 4.0
#: boards and steps of the card == CPU replay, and its configs
CARD_CPU_BATCH, CARD_CPU_STEPS = 512, 10
CARD_CPU_CONFIGS = ("flagship", "both")
#: [reset -> kernel]: configs (a [stepper] config, and the logical block of
#: the matrix row with its reward)
RESET_KERNEL = {"flagship": 256, "varpin_web": 256}


def _stepper_params(name):
    from placement_tpu_torch.utils.config import load_env_params
    want = json.loads(STEPPER_FIXTURE.read_text())[name]
    return load_env_params(want["config"]).replace(**want["overrides"]), want


def _free_by_conv(grid, ph, pw):
    """bool[B, H, W]: a ph x pw footprint anchored at the cell lies in the
    grid over free cells, by a convolution of the occupancy (independent of
    ``ops/sat.py``); one convolution per footprint the boards use."""
    import torch
    b, h, w = grid.shape
    occ = grid.to(torch.float32)[:, None]
    out = torch.zeros((b, h, w), dtype=torch.bool, device=grid.device)
    for a, c in {(int(p), int(q)) for p, q in zip(ph.tolist(), pw.tolist())}:
        if a > h or c > w:
            continue
        win = torch.nn.functional.conv2d(
            occ, torch.ones((1, 1, a, c), device=grid.device))[:, 0] == 0
        free = torch.zeros_like(out)
        free[:, :h - a + 1, :w - c + 1] = win
        out = torch.where(((ph == a) & (pw == c))[:, None, None], free, out)
    return out


def _check_step(label, params, before, after, reward, done):
    """Invariants of one auto-reset step of a random legal policy: occupied
    cells = the placed components' area; every legal cell free for its
    footprint; done boards hold fresh instances; the others placed one
    component; rewards finite."""
    import torch
    c = params.max_components
    area = (after.comp_h * after.comp_w).long()
    placed = torch.arange(c, device=area.device)[None, :] < after.cursor[:, None]
    if params.variant == 0:      # SQUARE: n x n components without a table
        want = after.cursor.long() * params.component_n ** 2
    else:
        want = (area * placed).sum(dim=1)
    _check(torch.equal(after.grid.long().sum(dim=(1, 2)), want),
           f"{label}: occupied cells != placed area")
    cur = after.cursor.long().clamp(max=c - 1)[:, None]
    ch = after.comp_h.gather(1, cur)[:, 0]
    cw = after.comp_w.gather(1, cur)[:, 0]
    for o in range(after.action_mask.shape[1]):
        ph, pw = (ch, cw) if o % 2 == 0 else (cw, ch)
        free = _free_by_conv(after.grid, ph, pw)
        _check(not bool((after.action_mask[:, o] & ~free).any()),
               f"{label}: a legal cell is not free for its footprint")
    d = done
    _check(bool((after.cursor[d] == 0).all() and (after.steps[d] == 0).all()
                and (after.grid[d] == 0).all() and (after.comp_x[d] == -1).all()
                and (after.pin_abs_x[d] == -1).all()
                and after.action_mask[d].flatten(1).any(dim=1).all()),
           f"{label}: a done board holds no fresh instance")
    _check(bool((after.cursor[~d] == before.cursor[~d] + 1).all()
                and (after.steps[~d] == before.steps[~d] + 1).all()),
           f"{label}: a live board did not place one component")
    _check(bool(torch.isfinite(reward).all()), f"{label}: reward not finite")


def _checked_steps(label, params, steps, batch, gen):
    """``steps`` auto-reset steps of the random policy through
    ``core.make_batched`` on the card, every step's invariants checked; the
    steps themselves run with PyTorch's sync debug mode set to raise, so a
    step that waits for the card fails. Returns the episodes ended."""
    import torch
    from placement_tpu_torch.agent import random_policy
    from placement_tpu_torch.env import core
    reset_b, step_b, obs_b = core.make_batched(params, "cuda")
    state = reset_b(gen, batch)
    episodes = 0
    for _ in range(steps):
        mask = state.action_mask
        torch.cuda.set_sync_debug_mode("error")
        try:
            action = random_policy.random_action(gen, params, mask)
            after, reward, done, _ = step_b(state, action, gen)
            obs = obs_b(after)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _check_step(label, params, state, after, reward, done)
        _check(all(bool(torch.isfinite(v).all()) for v in obs.values()),
               f"{label}: observation not finite")
        episodes += int(done.sum())
        state = after
    return episodes


def _simulate_mean(label, name, params, gen):
    """``random_policy.simulate`` on the card at ``BATCH`` boards and
    episodes, its mean return held to JAX's (the fixture) within
    ``STEPPER_SE`` combined standard errors. Returns (seconds, |delta|,
    combined standard error)."""
    import torch
    from placement_tpu_torch.agent import random_policy
    want = json.loads(STEPPER_FIXTURE.read_text())[name]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ret = random_policy.simulate(params, gen, BATCH, batch=BATCH,
                                 device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _check(tuple(ret.shape) == (BATCH,) and bool(torch.isfinite(ret).all()),
           f"{label}: simulate returns")
    r = ret.double()
    mean, se = float(r.mean()), float(r.std() / BATCH ** 0.5)
    both = (se ** 2 + want["se"] ** 2) ** 0.5
    delta = mean - want["mean"]
    print(f"[stepper] {label}: simulate mean return {mean!r} (se {se!r}, "
          f"{BATCH} episodes) vs JAX {want['mean']!r} (se {want['se']!r}, "
          f"{want['episodes']} episodes): delta {delta!r} = "
          f"{delta / both!r} combined se", flush=True)
    _check(abs(delta) <= STEPPER_SE * both, f"{label}: mean return")
    return dt


def _launches_per_step(params, gen):
    """Kernels the card runs in one auto-reset step at ``BATCH`` boards and
    their busy time, from ``torch.profiler`` (None when it records no
    device events)."""
    from placement_tpu_torch.agent import random_policy
    from placement_tpu_torch.env import core
    reset_b, step_b, _ = core.make_batched(params, "cuda")
    state = reset_b(gen, BATCH)

    def step():
        step_b(state, random_policy.random_action(gen, params,
                                                  state.action_mask), gen)

    step()
    _, n, busy, wall = _profiled(step)
    return None if n is None else (n, busy, wall)


def phase_stepper(gen):
    """[stepper], the flagship at full width: invariant-checked steps, the
    launches of a step, then ``simulate`` twice (warm-up, timed) at 4096
    boards and 102 steps; returns env-steps/s."""
    params, _ = _stepper_params("flagship")
    label = "flagship (configs/rectangle_pin_model.json)"
    ended = _checked_steps(label, params, STEPPER_STEPS, BATCH, gen)
    print(f"[stepper] {label}: {STEPPER_STEPS} checked steps x {BATCH} "
          f"boards, {ended} episodes ended, no sync inside a step")
    per_step = _launches_per_step(params, gen)
    if per_step is None:
        print("[stepper] launches per step: not measured (the profiler "
              "recorded no device events)")
    else:
        n, busy, wall = per_step
        print(f"[stepper] one auto-reset step, {BATCH} boards: {n} kernel "
              f"launches, device busy {busy!r} ms of {wall!r} ms wall "
              f"(idle share {1 - busy / wall!r})")
    _simulate_mean(label + " warm-up", "flagship", params, gen)
    dt = _simulate_mean(label, "flagship", params, gen)
    steps = params.area + 2
    rate = BATCH * steps / dt
    print(f"[stepper] {label}: random_policy.simulate, {BATCH} boards x "
          f"{steps} steps in {dt!r} s: {rate!r} env-steps/s; {_card()}",
          flush=True)
    return rate


def phase_stepper_families(gen):
    """[stepper], the other families at ``BATCH`` boards: invariant-checked
    steps and the mean return of ``simulate``; returns env-steps/s of each
    simulate call (one call, not warmed up)."""
    rates = {}
    for name in ("square", "rectangle", "rectangle_spatial_pin",
                 "varpin_web", "beam", "both"):
        params, want = _stepper_params(name)
        label = f"{name} ({want['config']} {want['overrides']})"
        ended = _checked_steps(label, params, STEPPER_STEPS, BATCH, gen)
        dt = _simulate_mean(label, name, params, gen)
        rates[name] = BATCH * (params.area + 2) / dt
        print(f"[stepper] {label}: {STEPPER_STEPS} checked steps, {ended} "
              f"episodes ended; simulate {rates[name]!r} env-steps/s")
    return rates


def phase_stepper_card_cpu(gen):
    """[stepper card == cpu]: the card's states and actions of
    ``CARD_CPU_STEPS`` auto-reset steps, each raw ``step`` + ``observe``
    replayed on the CPU from the same state: integer fields, masks, grids,
    done and observations equal; rewards and info within 1e-5."""
    import torch
    from placement_tpu_torch.agent import random_policy
    from placement_tpu_torch.env import core
    from placement_tpu_torch.env.types import STATE_FIELDS, EnvState
    worst = 0.0
    for name in CARD_CPU_CONFIGS:
        params, _ = _stepper_params(name)
        state = core.reset(params, gen, CARD_CPU_BATCH, "cuda")
        for t in range(CARD_CPU_STEPS):
            action = random_policy.random_action(gen, params,
                                                 state.action_mask)
            card, reward, done, info = core.step(params, state, action)
            cpu, c_reward, c_done, c_info = core.step(
                params, state.to("cpu"), action.cpu())
            card_cpu = card.to("cpu")
            for f in STATE_FIELDS:
                a, b = getattr(card_cpu, f), getattr(cpu, f)
                if a.dtype == torch.float32:
                    worst = max(worst, float((a - b).abs().max()))
                    _check(torch.allclose(a, b, rtol=0, atol=1e-5),
                           f"{name} step {t}: {f} card != cpu")
                else:
                    _check(torch.equal(a, b), f"{name} step {t}: {f} "
                                              "card != cpu")
            err = float((reward.cpu() - c_reward).abs().max())
            worst = max(worst, err)
            _check(err <= 1e-5 and torch.equal(done.cpu(), c_done),
                   f"{name} step {t}: reward / done card != cpu")
            obs_card, obs_cpu = core.observe(params, card), core.observe(
                params, cpu)
            for k, v in obs_cpu.items():
                _check(torch.equal(obs_card[k].cpu(), v),
                       f"{name} step {t}: observation {k} card != cpu")
            fresh = core.reset(params, gen, CARD_CPU_BATCH, "cuda")
            state = EnvState.where(done, fresh, card)
        print(f"[stepper card == cpu] {name}: {CARD_CPU_STEPS} steps x "
              f"{CARD_CPU_BATCH} boards: integer fields, masks, grids, done "
              f"and observations equal; worst |reward or info diff| "
              f"{worst!r}", flush=True)
    return worst


def phase_reset_kernel(name, block, gen):
    """[reset -> kernel]: ``init_leaves`` on the card, then one 50-step chunk
    of the CUDA kernel from those boards against its plain version from the
    same leaves (phase 5's rule: leaves and done counts equal, board sums
    equal, within 1e-5 where the centroid route's terms are added in
    another order). Returns (launches, max abs error)."""
    import torch
    from placement_tpu_torch.ops import fused_rollout as fr
    params, _ = _stepper_params(name)
    leaves = fr.init_leaves(params, gen, BATCH, "cuda")
    _check(int(leaves["cursor"].sum()) == 0
           and bool((leaves["plane0"].sum(1) > 0).all()),
           f"{name}: init_leaves are not fresh boards")
    fn = fr.make_fused_rollout(params, BATCH, STEPS, block=block,
                               device="cuda")
    fn.launches = 0
    got, got_r, got_d = fn.per_board(leaves, 1)
    launches = fn.launches
    want, want_r, want_d = fr.rollout_chunk_reference(params, leaves, 1,
                                                      STEPS, block)
    torch.cuda.synchronize()
    bad = [k for k in fr._LEAVES if not torch.equal(got[k], want[k])]
    err = float((got_r - want_r).abs().max())
    print(f"[reset -> kernel] {name} ({fn.kernel} kernel): {BATCH} reset "
          f"boards, block {block}, {STEPS} steps: leaves differing {bad}, "
          f"done counts equal {torch.equal(got_d, want_d)}, max |board "
          f"reward diff| {err!r} (equal: {torch.equal(got_r, want_r)}), "
          f"{int(got_d.sum())} episodes; launches {launches}", flush=True)
    _check(not bad and torch.equal(got_d, want_d),
           f"{name}: kernel from reset boards differs from the plain version")
    _check(err <= 1e-5, f"{name}: board rewards differ")
    _check(launches == 1, f"{name}: the path missed the kernel")
    return launches, err


def phase_dryrun():
    """The entry point ``graft_entry.dryrun_multigpu(2)``: two spawned ranks
    (sharing the card on a machine with one), the learner half (one
    sharded PPO train step: every metric finite, the same on both ranks)
    and the fused half from reset boards. Returns its kernel launches."""
    import math
    from placement_tpu_torch import graft_entry
    results = graft_entry.dryrun_multigpu(2)
    launches = sum(res["launches"] for res in results)
    metrics = results[0]["metrics"]
    print(f"[entry point] graft_entry.dryrun_multigpu(2): train step "
          f"{metrics!r}; totals {results[0]['totals']}, launches "
          f"{[r['launches'] for r in results]}", flush=True)
    _check(launches == 2, "the dry run missed the kernel")
    _check(all(math.isfinite(v) for v in metrics.values())
           and results[1]["metrics"] == metrics,
           "the dry run's train step: metrics not finite or not the same "
           "on both ranks")
    return launches


# ---------------------------------------------------------------------------
# The policy path: models, Policy.act and the pooled engine
# ---------------------------------------------------------------------------

#: the flagship policy's Flax weights, 64 JAX observations and JAX's
#: outputs on them, and JAX's pooled-rollout mean return of that policy
#: (recorded by ``PYTHONPATH=. python tests/test_torch_policy.py``)
POLICY_FIXTURE = FIXTURES / "torch_policy_flagship.npz"
#: logits and value against JAX's and the CPU's: relative, with cuDNN's
#: TF32 off for the whole run (``phase_device``), f32 sums in another order
POLICY_RTOL = 1e-4
#: timed chunks of the pooled paths; forwards timed at 4096 boards
POOLED_CHUNKS, FORWARDS = 4, 20
#: the pooled paths' finisher budget (``bench.py:177-198``: batch // 4)
ROUTE_BUDGET = BATCH // 4


def _policy_fixture(device):
    """(flagship params, the policy with the fixture's weights on
    ``device``, the fixture's observations there, the fixture)."""
    import numpy as np
    import torch
    from placement_tpu_torch.agent.policy import Policy
    from placement_tpu_torch.models import convert
    from placement_tpu_torch.utils.config import load_experiment
    data = dict(np.load(POLICY_FIXTURE))
    variables = convert.unflatten({k[4:]: v for k, v in data.items()
                                   if k.startswith("var/")})
    params, cfg, _ = load_experiment("rectangle_pin")
    policy = Policy(params, cfg, device).load_flax(variables)
    obs = {k[4:]: torch.as_tensor(v, device=device)
           for k, v in data.items() if k.startswith("obs/")}
    return params, policy, obs, data


def _rel_err(got, want):
    """max |got - want| / max(1, |want|) over the finite entries (masked
    logits sit at f32's lowest value in both)."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


def phase_policy(gen):
    """[policy]: the flagship model with the Flax weights carried across
    (``models/convert.py``) on the card, on the fixture's 64 JAX
    observations: logits and value within ``POLICY_RTOL`` of JAX's and of
    the CPU's, greedy actions JAX's wherever JAX's top two logits are
    further apart; then the forward's ms at 4096 reset boards. Returns the
    forward's ms."""
    import numpy as np
    import torch
    from placement_tpu_torch.env import core
    params, card, obs, data = _policy_fixture("cuda")
    _, cpu, cpu_obs, _ = _policy_fixture("cpu")
    action, logp, value, logits = card.act(obs, gen, deterministic=True)
    c_action, _, c_value, c_logits = cpu.act(cpu_obs, torch.Generator(),
                                             deterministic=True)
    logits, value = logits.cpu().numpy(), value.cpu().numpy()
    err_jax = max(_rel_err(logits, data["logits"]),
                  _rel_err(value, data["value"]))
    err_cpu = max(_rel_err(logits, c_logits.numpy()),
                  _rel_err(value, c_value.numpy()))
    top2 = np.sort(data["logits"], axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > POLICY_RTOL * np.maximum(
        1.0, np.abs(top2[:, 1]))
    action = action.cpu().numpy()
    same_jax = bool((action[clear] == data["greedy"][clear]).all())
    same_cpu = bool((action[clear] == c_action.numpy()[clear]).all())
    print(f"[policy] flagship model, Flax weights carried, {len(action)} "
          f"JAX observations: max rel |logits or value - JAX| {err_jax!r}, "
          f"- CPU {err_cpu!r} (tolerance {POLICY_RTOL}, TF32 off); greedy "
          f"actions equal to JAX's on {int(clear.sum())} boards with a clear "
          f"top logit: {same_jax}, to the CPU's: {same_cpu}; all boards: "
          f"{int((action == data['greedy']).all(1).sum())} of {len(action)}",
          flush=True)
    _check(err_jax <= POLICY_RTOL and err_cpu <= POLICY_RTOL,
           "policy logits or value differ")
    _check(same_jax and same_cpu and clear.sum() >= len(clear) // 2,
           "greedy actions differ")
    _check(np.isfinite(value).all(), "policy value not finite")
    _check(np.allclose(logp.cpu().numpy()[clear], data["greedy_logp"][clear],
                       rtol=POLICY_RTOL, atol=POLICY_RTOL),
           "greedy logp differs")

    states = core.reset(params, gen, BATCH, "cuda")
    big = core.observe(params, states)
    with torch.no_grad():
        for _ in range(5):
            card.model(big)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(FORWARDS):
            out = card.model(big)
        end.record()
        torch.cuda.synchronize()
    ms = start.elapsed_time(end) / FORWARDS
    _check(tuple(out["logits"].shape) == (BATCH, 400)
           and bool(torch.isfinite(out["value"]).all()), "forward outputs")
    with torch.no_grad():
        _, n, busy, wall = _profiled(lambda: card.model(big))
    print(f"[policy] forward at {BATCH} boards: {ms!r} ms (CUDA events, "
          f"{FORWARDS} forwards after 5); one forward profiled: {n} kernel "
          f"launches, device busy {busy!r} ms of {wall!r} ms wall; "
          f"{_card()}", flush=True)
    return ms


def _pooled_step_profile(params, policy_fn, gen, pool_size):
    """Kernels the card runs in one pooled step (``policy_fn`` then
    ``step_autoreset_pooled`` with ``ROUTE_BUDGET``) at ``BATCH`` boards,
    their busy ms and the step's wall ms, from ``torch.profiler`` (None
    when it records no device events)."""
    import torch
    from placement_tpu_torch.env import core, pooled
    states = core.reset(params, gen, BATCH, "cuda")
    pool = pooled.make_pool(params, gen, pool_size, BATCH)
    counts = torch.zeros((BATCH,), dtype=torch.int32, device="cuda")

    def step(states, counts):
        return pooled.step_autoreset_pooled(
            params, states, policy_fn(gen, params, states), pool, counts,
            ROUTE_BUDGET)[:2]

    states, counts = step(states, counts)
    _, n, busy, wall = _profiled(lambda: step(states, counts))
    return None if n is None else (n, busy, wall)


def _pooled_run(label, params, policy_fn, gen, want_mean, want_se):
    """``pooled.rollout_chunk`` of ``policy_fn`` on ``params`` at ``BATCH``
    boards from reset: 50-step chunks, the pool ``default_pool_size``,
    ``ROUTE_BUDGET``; one warm-up chunk, then ``POOLED_CHUNKS`` timed
    chunks synced by fetching their reward sums. Checks the wraps (0), the
    episode accounting (5-step episodes) and the mean return against
    (``want_mean``, ``want_se``) within ``STEPPER_SE`` combined standard
    errors. Returns (env-steps/s, launches, busy ms, wall ms of a step)."""
    import numpy as np
    import torch
    from placement_tpu_torch.env import core, pooled
    pool_size = pooled.default_pool_size(params, STEPS)
    fn = pooled.rollout_chunk(params, policy_fn, STEPS, pool_size,
                              route_budget=ROUTE_BUDGET)
    states = core.reset(params, gen, BATCH, "cuda")
    states, r, d, w = fn(states, gen)
    _check(int(w) == 0 and int(d) == 10 * BATCH, f"{label}: warm-up chunk")
    prof = _pooled_step_profile(params, policy_fn, gen, pool_size)
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(POOLED_CHUNKS):
        states, r, d, w = fn(states, gen)
        out.append((r, d, w))
    sums = [(float(r), int(d), int(w)) for r, d, w in out]   # the sync
    dt = time.perf_counter() - t0
    rate = BATCH * STEPS * POOLED_CHUNKS / dt
    means = [r / d for r, d, _ in sums]
    mean = float(np.mean(means))
    se = float(np.std(means, ddof=1) / np.sqrt(len(means)))
    both = (se ** 2 + want_se ** 2) ** 0.5
    wraps = sum(w for *_, w in sums)
    print(f"[{label}] flagship, {BATCH} boards, {POOLED_CHUNKS} chunks of "
          f"{STEPS} steps, pool {pool_size}, route budget {ROUTE_BUDGET}: "
          f"{dt!r} s, {rate!r} env-steps/s; wrap_count {wraps}; "
          f"{sum(d for _, d, _ in sums)} episodes, mean return {mean!r} (se "
          f"{se!r}) vs JAX {want_mean!r} (se {want_se!r}): delta "
          f"{(mean - want_mean) / both!r} combined se; {_card()}",
          flush=True)
    if prof is None:
        print(f"[{label}] launches per step: not measured (the profiler "
              "recorded no device events)")
        prof = (None, None, None)
    else:
        n, busy, wall = prof
        print(f"[{label}] one pooled step, {BATCH} boards: {n} kernel "
              f"launches, device busy {busy!r} ms of {wall!r} ms wall (busy "
              f"share {busy / wall!r}, idle share {1 - busy / wall!r})",
              flush=True)
    _check(wraps == 0, f"{label}: pool wraps")
    _check(all(d == 10 * BATCH for _, d, _ in sums),
           f"{label}: episode accounting")
    _check(bool(torch.isfinite(states.info_wirelength).all()),
           f"{label}: states")
    _check(abs(mean - want_mean) <= STEPPER_SE * both, f"{label}: mean "
                                                       "return")
    return (rate,) + tuple(prof)


def _profiled(fn):
    """(result, kernel launches, device busy ms, wall ms) of ``fn()`` run
    once under ``torch.profiler``, the card idle before and after; the
    launches and busy time are None when the profiler records no device
    events (``tools/_timing.py::profile_once``)."""
    import torch
    from placement_tpu_torch.tools._timing import profile_once
    out = []
    prof = profile_once(lambda: out.append(fn()), torch.device("cuda"))
    return out[0], prof["launches"], prof["device_busy_ms"], prof["wall_ms"]


def _policy_step_breakdown(params, policy, gen):
    """Where a ``[policy rollout]`` step's time goes: its parts run one by
    one, each profiled alone (launches, device busy ms, wall ms with the
    card synced before and after), on a step where no board finishes
    (step 2 from reset) and on one where every board does (step 5, the
    flagship's lockstep episode end: the whole batch routed)."""
    import torch
    from placement_tpu_torch.env import core, pooled
    from placement_tpu_torch.env.types import EnvState
    states = core.reset(params, gen, BATCH, "cuda")
    pool = pooled.make_pool(params, gen, 12, BATCH)
    counts = torch.zeros((BATCH,), dtype=torch.int32, device="cuda")
    for t in range(5):
        parts = {}
        obs, *parts["observe"] = _profiled(
            lambda: core.observe(params, states))
        action, *parts["forward + sample"] = _profiled(
            lambda: policy.act(obs, gen)[0])
        (stepped, _, done, aux), *parts["step, routing deferred"] = \
            _profiled(lambda: core.step(params, states, action,
                                        defer_routing=True))
        _, *parts["gated routing (host read)"] = _profiled(
            lambda: pooled.gated_terminal_rewards(
                params, stepped, done, aux["placed_all_eff"], ROUTE_BUDGET))
        states, *parts["pool take + where"] = _profiled(
            lambda: EnvState.where(done, pooled.take(pool, counts), stepped))
        counts = counts + done.to(torch.int32)
        if t in (1, 4):
            print(f"[policy rollout] step {t + 1} parts ({int(done.sum())} "
                  f"boards finish), launches / device busy ms / wall ms: "
                  f"{parts!r}", flush=True)


def phase_policy_rollout(gen):
    """[policy rollout], the slice's main path: the flagship policy (the
    fixture's weights, sampling) acting on ``BATCH`` flagship boards
    through ``pooled.rollout_chunk`` (PPO's rollout half,
    ``agent/ppo.py:179-247``); then where a step's time goes."""
    params, policy, _, data = _policy_fixture("cuda")
    out = _pooled_run("policy rollout", params, policy.policy_fn(), gen,
                      float(data["rollout_mean"]),
                      float(data["rollout_se"]))
    _policy_step_breakdown(params, policy, gen)
    return out


def phase_pooled(gen):
    """[pooled]: the random policy through ``pooled.rollout_chunk`` on the
    flagship (``bench.py:177-198``), its mean return held to JAX
    ``simulate``'s; then gated == ungated routing on the card."""
    import torch
    from placement_tpu_torch.agent import random_policy
    params, want = _stepper_params("flagship")
    out = _pooled_run(
        "pooled", params,
        lambda g, p, s: random_policy.random_action(g, p, s.action_mask),
        gen, want["mean"], want["se"])
    return out + (_gated_vs_ungated(params, gen),)


def _gated_vs_ungated(params, gen, steps=12):
    """The pooled step with and without ``ROUTE_BUDGET`` from the same
    states, pool and actions on the card; a tenth of the budget's boards
    play off the board at step 2, so later steps route a few finishers (the compacted branch)
    besides the lockstep ones (the full batch) and none. States equal but
    the wirelength; crossings equal; wirelength and reward within one f32
    ulp. Returns the largest wirelength difference."""
    import torch
    from placement_tpu_torch.agent import random_policy
    from placement_tpu_torch.env import core, pooled
    from placement_tpu_torch.env.types import STATE_FIELDS
    s_e = s_g = core.reset(params, gen, BATCH, "cuda")
    pool = pooled.make_pool(params, gen, 6, BATCH)
    c_e = c_g = torch.zeros((BATCH,), dtype=torch.int32, device="cuda")
    worst, branches, bad = 0.0, set(), ROUTE_BUDGET // 10
    for t in range(steps):
        a = random_policy.random_action(gen, params, s_e.action_mask)
        if t == 2:
            a[:bad] = torch.tensor([0, -5, -5], device="cuda")
        s_e, c_e, r_e, d_e, i_e = pooled.step_autoreset_pooled(
            params, s_e, a, pool, c_e)
        s_g, c_g, r_g, d_g, i_g = pooled.step_autoreset_pooled(
            params, s_g, a, pool, c_g, ROUTE_BUDGET)
        n = int(d_e.sum())
        branches.add("none" if n == 0 else "compacted" if n <= ROUTE_BUDGET
                     else "full")
        _check(torch.equal(d_e, d_g) and torch.equal(c_e, c_g)
               and all(torch.equal(getattr(s_e, f), getattr(s_g, f))
                       for f in STATE_FIELDS if f != "info_wirelength")
               and torch.equal(i_e["num_intersections"],
                               i_g["num_intersections"]),
               f"gated != ungated at step {t}")
        for x, y in ((i_e["wirelength"], i_g["wirelength"]), (r_e, r_g)):
            ulp = torch.finfo(torch.float32).eps * torch.maximum(
                x.abs(), y.abs())
            _check(bool(((x - y).abs() <= ulp).all()),
                   f"gated wirelength or reward off by more than an ulp at "
                   f"step {t}")
            worst = max(worst, float((x - y).abs().max()))
    print(f"[pooled] gated == ungated on the card: {steps} steps x {BATCH} "
          f"boards (branches {sorted(branches)}): states, dones, counts and "
          f"crossings equal; largest |wirelength or reward diff| {worst!r}",
          flush=True)
    _check(branches == {"none", "compacted", "full"},
           f"gated branches seen: {branches}")
    return worst


def phase_matrix_pooled():
    """[matrix] web_max_pooled: the web app's slider maximum on the pooled
    engine, through ``bench_matrix.measure_pooled`` with the JAX tool's
    tuning."""
    import math
    from placement_tpu_torch.tools import bench_matrix as bm
    params, anchor = bm._configs()["web_max_pooled"]
    row = bm.measure_pooled("web_max_pooled", params, anchor, "cuda",
                            **bm.POOLED_TUNING["web_max_pooled"])
    print(f"[matrix] web_max_pooled: {row['engine']}, {row['batch']} boards, "
          f"pool {row['pool_size']}, route budget {row['route_budget']}: "
          f"{row['steps_per_sec']!r} env-steps/s over {row['calls']} calls "
          f"of {row['chunk_steps']} steps; wraps {row['wraps']}; "
          f"{row['episodes']} episodes, mean episode reward "
          f"{row['mean_episode_reward']!r}; {row['card']}", flush=True)
    _check(row["wraps"] == 0, "web_max_pooled wrapped its pool")
    _check(row["episodes"] > 0 and math.isfinite(row["mean_episode_reward"]),
           "web_max_pooled episodes")
    return row["steps_per_sec"]


def phase_entry():
    """[entry point] ``graft_entry.entry()``: the flagship forward step on
    the card."""
    import torch
    from placement_tpu_torch import graft_entry
    fn, args = graft_entry.entry()
    logits, value = fn(*args)
    print(f"[entry point] graft_entry.entry(): logits "
          f"{tuple(logits.shape)}, value {tuple(value.shape)} on "
          f"{logits.device}", flush=True)
    legal = args[1]["action_mask"].reshape(logits.shape[0], -1) > 0
    _check(logits.device.type == "cuda"
           and tuple(logits.shape) == (16, 400)
           and tuple(value.shape) == (16,)
           and bool(torch.isfinite(value).all())
           and bool(torch.isfinite(logits[legal]).all()),
           "entry outputs")



# ---------------------------------------------------------------------------
# The learner: Policy.evaluate, PPO, the Trainer
# ---------------------------------------------------------------------------

#: loss, gradients and one update, card against CPU, with TF32 off
#: (``phase_device``): relative to each gradient tensor's largest entry,
#: to max(1, |CPU|) for the loss and its aux (the KL and the surrogate's
#: mean sit near 0 by cancellation), absolute for the parameters
LEARNER_RTOL = 1e-4
#: the gradient of a bias that feeds a batch norm is 0 in exact arithmetic
#: (``convert.norm_fed_biases``): noise on both devices, held below this
NORM_FED_GRAD = 1e-5
#: the ``[train]`` main path: iterations before and after the restore
TRAIN_ITERS, TRAIN_MORE = 3, 1
#: progress.csv's columns as the JAX ``Trainer`` writes them (held to a JAX
#: run by tests/test_torch_trainer.py)
JAX_PROGRESS_COLUMNS = [
    "training_iteration", "timesteps_total", "time_total_s", "entropy",
    "episode_len_mean", "episode_reward_mean", "episodes_this_iter", "kl",
    "kl_coeff", "custom_metrics/normalized_wirelengths_mean",
    "custom_metrics/num_intersections_mean", "policy_loss", "pool_wraps",
    "vf_loss"]
#: ``[train learns]``: tests/agent/test_ppo.py:174-193 on the card
LEARNS_ITERS = 40


def _fixture_variables():
    import numpy as np
    from placement_tpu_torch.models import convert
    data = dict(np.load(POLICY_FIXTURE))
    return convert.unflatten({k[4:]: v for k, v in data.items()
                              if k.startswith("var/")})


def _worst_rel(got, want):
    """max |got - want| / max |want| over a tensor."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def phase_learner(device="cuda"):
    """[learner]: the carried flagship on one minibatch of 128 transitions
    of a CPU rollout: the loss, its aux and every gradient on ``device`` and
    on the CPU within ``LEARNER_RTOL`` of the tensor's scale (the norm-fed
    biases' noise below ``NORM_FED_GRAD``); then one ``update``
    (``num_sgd_iter`` 2 over 1024 transitions: 16 Adam steps) fed the same
    window and permutations: parameters and batch statistics within
    ``LEARNER_RTOL`` of the CPU's (the norm-fed biases within 2 * lr a
    step), ``kl_coeff`` and the metrics within ``LEARNER_RTOL``."""
    import torch
    from placement_tpu_torch.agent.ppo import PPOConfig, PPOLearner
    from placement_tpu_torch.models import convert
    variables = _fixture_variables()
    params, card, _, _ = _policy_fixture(device)
    _, cpu, _, _ = _policy_fixture("cpu")
    cfg = PPOConfig(num_envs=128, unroll_length=8, num_sgd_iter=2)
    c_learner, g_learner = (PPOLearner(params, cpu, cfg),
                            PPOLearner(params, card, cfg))
    c_state = c_learner.init(torch.Generator().manual_seed(0), variables)
    g_state = g_learner.init(torch.Generator(device).manual_seed(0),
                             variables)
    c_state, traj, last_value, _ = c_learner.rollout(c_state)
    batch = c_learner.flat_batch(traj, last_value)
    sel = torch.arange(128)

    def take(to):
        return {k: ({o: x[sel].to(to) for o, x in v.items()} if k == "obs"
                    else v[sel].to(to)) for k, v in batch.items()}

    out = {}
    for name, learner, state, gen in (
            ("cpu", c_learner, c_state, torch.Generator()),
            ("card", g_learner, g_state, torch.Generator(device))):
        loss, aux = learner._loss(take(learner.device), state.kl_coeff, gen)
        loss.backward()
        out[name] = ({k: v.detach() for k, v in
                      {"loss": loss, **aux}.items()},
                     convert.flax_grads(learner.policy.model))
        learner.policy.load_flax(variables)     # undo the train forward
    (c_aux, c_grads), (g_aux, g_grads) = out["cpu"], out["card"]
    noise = convert.norm_fed_biases(c_grads)
    aux_err = {k: _rel_err(g_aux[k].cpu(), c_aux[k]) for k in c_aux}
    loss_err = max(aux_err.values())
    grad_err = max(_worst_rel(g_grads[k], c_grads[k])
                   for k in c_grads if k not in noise)
    noise_max = max(max(abs(g_grads[k]).max(), abs(c_grads[k]).max())
                    for k in noise)
    print(f"[learner] flagship, Flax weights carried, minibatch of 128 "
          f"from a CPU rollout, TF32 off: loss and aux on the CPU "
          f"{ {k: float(v) for k, v in c_aux.items()}!r}; card vs CPU: "
          f"|diff| / max(1, |CPU|) {aux_err!r}; worst rel err of the "
          f"gradients {grad_err!r} over {len(c_grads) - len(noise)} tensors "
          f"(tolerance {LEARNER_RTOL}); the {len(noise)} norm-fed biases' "
          f"gradients at most {float(noise_max)!r} (bound {NORM_FED_GRAD})",
          flush=True)
    _check(loss_err <= LEARNER_RTOL and grad_err <= LEARNER_RTOL,
           "learner loss or gradients: card != CPU")
    _check(noise and noise_max <= NORM_FED_GRAD, "norm-fed bias gradients")

    perm_gen = torch.Generator().manual_seed(1)
    perms = [torch.randperm(cfg.train_batch, generator=perm_gen)
             for _ in range(cfg.num_sgd_iter)]
    c_state, want = c_learner.update(c_state, traj, last_value, perms)
    g_state, got = g_learner.update(g_state, traj.to(device),
                                    last_value.to(device), perms)
    metric_err = max(_rel_err(got[k].cpu(), want[k]) for k in want)
    w_sd = convert.to_flax(cpu.model.state_dict())
    g_sd = convert.to_flax(card.model.state_dict())
    steps = cfg.num_sgd_iter * cfg.train_batch // cfg.minibatch_size
    param_err = max(float(abs(g_sd[k] - w_sd[k]).max())
                    for k in w_sd if k not in noise)
    noise_err = max(float(abs(g_sd[k] - w_sd[k]).max()) for k in noise)
    moved = max(float(abs(w_sd[k] - convert.flatten(variables)[k]).max())
                for k in w_sd)
    print(f"[learner] one update, {steps} Adam steps, card vs CPU: metrics "
          f"|diff| / max(1, |CPU|) {metric_err!r}; parameters and statistics worst "
          f"abs err {param_err!r} (tolerance {LEARNER_RTOL}; they moved by "
          f"up to {moved!r}); norm-fed biases {noise_err!r} (bound "
          f"{2 * cfg.lr * steps!r}); kl_coeff {float(got['kl_coeff'])!r}",
          flush=True)
    _check(metric_err <= LEARNER_RTOL and param_err <= LEARNER_RTOL
           and noise_err <= 2 * cfg.lr * steps and moved > LEARNER_RTOL,
           "learner update: card != CPU")
    return max(loss_err, grad_err, metric_err)


#: ``[zoo learner]``: the learner's config of each preset's minibatch (a
#: 128-board CPU rollout, its first ``minibatch_size`` transitions) and of
#: its one iteration on the card
ZOO_LEARNER_ROLLOUT = dict(num_envs=128, unroll_length=8)
ZOO_LEARNER_TRAIN = dict(num_envs=128, unroll_length=32, num_sgd_iter=2)


def phase_zoo_learner(device="cuda"):
    """[zoo learner]: every preset of the zoo but the flagship
    (``[learner]``'s) at its published widths, its weights drawn with
    Flax's initializers from torch seed 0. On the first 128 transitions of
    a CPU rollout, the loss, its aux and every gradient on ``device`` and
    on the CPU within ``LEARNER_RTOL`` of the tensor's scale, the noise of
    the gradients that are 0 in exact arithmetic (the norm-fed biases and
    the attention key projections' biases, ``convert.key_biases``) below
    ``NORM_FED_GRAD`` (TF32 off, ``phase_device``);
    the factorized presets with ``kl_coeff`` = ``entropy_coeff`` = 0 and
    their sampled entropy and KL left out of the comparison. Then one
    ``Trainer`` iteration on ``device`` at 128 x 32, ``num_sgd_iter`` 2:
    metrics finite, the parameters moved, 0 pool wraps. Returns {preset:
    (worst error, the iteration's seconds, peak MB)}."""
    import math
    import tempfile
    import torch
    from placement_tpu_torch.agent.policy import Policy
    from placement_tpu_torch.agent.ppo import PPOConfig, PPOLearner
    from placement_tpu_torch.agent.trainer import Trainer
    from placement_tpu_torch.models import MODEL_REGISTRY, convert
    from placement_tpu_torch.utils.config import load_experiment
    cuda = torch.device(device).type == "cuda"
    out = {}
    for model_type in MODEL_REGISTRY:
        if model_type == "rectangle_pin":
            continue
        t0 = time.perf_counter()
        env_params, model_cfg, _ = load_experiment(model_type)
        zero = ({"kl_coeff": 0.0, "entropy_coeff": 0.0}
                if model_cfg.is_factorized else {})
        cfg = PPOConfig(**ZOO_LEARNER_ROLLOUT, **zero)
        grads, auxes = {}, {}
        for d in ("cpu", device):
            learner = PPOLearner(env_params, Policy(env_params, model_cfg, d),
                                 cfg)
            state = learner.init(torch.Generator(d).manual_seed(0))
            if d == "cpu":
                _, traj, last_value, _ = learner.rollout(state)
                batch = learner.flat_batch(traj, last_value)
                sel = torch.arange(cfg.minibatch_size)
            mb = {k: ({o: x[sel].to(d) for o, x in v.items()} if k == "obs"
                      else v[sel].to(d)) for k, v in batch.items()}
            loss, aux = learner._loss(mb, state.kl_coeff, torch.Generator(d))
            loss.backward()
            auxes[d] = {k: float(v.detach())
                        for k, v in {"loss": loss, **aux}.items()
                        if not (zero and k in ("entropy", "kl"))}
            grads[d] = convert.flax_grads(learner.policy.model)
        c_grads, g_grads = grads["cpu"], grads[device]
        noise = convert.norm_fed_biases(c_grads) | convert.key_biases(c_grads)
        aux_err = max(abs(auxes[device][k] - v) / max(1.0, abs(v))
                      for k, v in auxes["cpu"].items())
        grad_err = max(_worst_rel(g_grads[k], c_grads[k])
                       for k in c_grads if k not in noise)
        noise_max = max((float(max(abs(g_grads[k]).max(),
                                   abs(c_grads[k]).max())) for k in noise),
                        default=0.0)
        _check(aux_err <= LEARNER_RTOL and grad_err <= LEARNER_RTOL,
               f"[zoo learner] {model_type}: loss {aux_err!r} or gradients "
               f"{grad_err!r}, card != CPU")
        _check(noise_max <= NORM_FED_GRAD,
               f"[zoo learner] {model_type}: norm-fed or key bias gradients "
               f"{noise_max!r}")

        root = tempfile.mkdtemp(prefix="chip_smoke_zoo_learner_")
        try:
            trainer = Trainer(model_type, ppo_config=PPOConfig(
                **ZOO_LEARNER_TRAIN), results_root=root, device=device,
                run_name=f"PPO_{model_type}_zoo", use_tensorboard=False)
            state = trainer.init_state(0)
            before = {k: v.clone() for k, v in
                      state.model.state_dict().items()}
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t_it = time.perf_counter()
            try:
                result = trainer.run(1, state=state)
            finally:
                trainer.close()
            if cuda:
                torch.cuda.synchronize()
            it_s = time.perf_counter() - t_it
        finally:
            shutil.rmtree(root, ignore_errors=True)
        peak = torch.cuda.max_memory_allocated() / 2**20 if cuda else None
        row = result.final_metrics
        after = result.state.model.state_dict()
        moved = max(float((after[k].float() - before[k].float()).abs().max())
                    for k in before)
        print(f"[zoo learner] {model_type}: card vs CPU on 128 transitions, "
              f"loss and aux |diff| / max(1, |CPU|) {aux_err!r}, worst rel "
              f"err of {len(c_grads) - len(noise)} gradients {grad_err!r} "
              f"(tolerance {LEARNER_RTOL}), {len(noise)} norm-fed or key "
              f"biases at most {noise_max!r} (bound {NORM_FED_GRAD}); one "
              f"iteration "
              f"(128 x 32, 2 epochs) {it_s!r} s, reward "
              f"{row['episode_reward_mean']!r}, wraps "
              f"{row['pool_wraps']!r}, moved {moved!r}; peak {peak!r} MB; "
              f"{time.perf_counter() - t0!r} s in all", flush=True)
        _check(all(math.isfinite(v) for v in row.values()),
               f"[zoo learner] {model_type}: a metric is not finite")
        _check(moved > 0, f"[zoo learner] {model_type}: nothing moved")
        _check(row["pool_wraps"] == 0, f"[zoo learner] {model_type}: wraps")
        out[model_type] = (max(aux_err, grad_err), it_s, peak)
    return out


def _timed(times, name, fn, device):
    """``fn`` with its wall time (the device synced before and after)
    appended to ``times[name]``."""
    import torch

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def wrapper(*args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        times[name].append(time.perf_counter() - t0)
        return out
    return wrapper


#: cuBLAS's workspace setting under which its results are deterministic
CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms, cuDNN deterministic and not
    benchmarking, for a block or a function (a decorator); the settings
    before it afterwards. ``[train]`` and ``[train dp]`` run so: world 1
    is then bitwise reproducible, and what tells the worlds apart is the
    sharding alone (cuBLAS also needs ``CUBLAS_WORKSPACE_CONFIG``, which
    ``phase_device`` sets before CUDA starts)."""
    import torch
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]
        torch.backends.cudnn.benchmark = saved[3]


@_deterministic()
def phase_train(device="cuda"):
    """[train], this slice's main path: ``Trainer("rectangle_pin")`` with
    the default ``PPOConfig`` (128 boards x 32 steps, 30 epochs of 32
    minibatches: 960 Adam steps an iteration) from the fixture's Flax
    weights, ``TRAIN_ITERS`` iterations into a temporary results root, a
    restore and ``TRAIN_MORE`` more; then ``generate_rollouts``. Returns
    (seconds an iteration, rollout s, update s, env-steps/s, Adam
    steps/s, launches and busy share of a minibatch step, peak MB,
    iteration 1's metrics row, the temporary results root, which the
    caller removes, the run dir, every iteration's logged row). Runs
    under ``_deterministic``."""
    import csv
    import math
    import os
    import tempfile
    import numpy as np
    import torch
    from placement_tpu_torch.agent.trainer import Trainer
    from placement_tpu_torch.viz.rollout import generate_rollouts
    variables = _fixture_variables()
    data = dict(np.load(POLICY_FIXTURE))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    trainer = Trainer("rectangle_pin", results_root=root, device=device,
                      run_name="PPO_rectangle_pin_smoke")
    learner = trainer.learner
    times = {"rollout": [], "update": [], "iteration": []}
    windows = []
    rollout = _timed(times, "rollout", learner.rollout, device)

    def rollout_kept(state):
        out = rollout(state)
        windows.append(out[1])
        return out

    learner.rollout = rollout_kept
    learner.update = _timed(times, "update", learner.update, device)
    rows, logged = [], []
    t_last = [time.perf_counter()]

    def on_iteration(it, row):
        now = time.perf_counter()
        times["iteration"].append(now - t_last[0])
        t_last[0] = now
        rows.append((it, row))
        logged.append(dict(row))

    state = trainer.init_state(0, flax_variables=variables)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    t_last[0] = time.perf_counter()
    result = trainer.run(TRAIN_ITERS, state=state, on_iteration=on_iteration)
    n = learner.cfg.train_batch
    # iteration 1's episodes: the carried policy's returns (terminal
    # rewards, every board from reset)
    w = windows[0]
    returns = w.reward[w.done].double().cpu().numpy()
    mean, se = float(returns.mean()), float(
        returns.std(ddof=1) / math.sqrt(len(returns)))
    want, want_se = float(data["rollout_mean"]), float(data["rollout_se"])
    delta = (mean - want) / math.hypot(se, want_se)
    with open(os.path.join(result.run_dir, "progress.csv"), newline="") as f:
        header = next(csv.reader(f))
    after = result.state.model.state_dict()
    moved = max(float((after[k].float() - before[k].float()).abs().max())
                for k in before)
    print(f"[train] Trainer('rectangle_pin'), default PPOConfig ({n} "
          f"transitions, {learner.cfg.num_sgd_iter} epochs x "
          f"{n // learner.cfg.minibatch_size} minibatches), Flax weights "
          f"carried: {TRAIN_ITERS} iterations; rows {rows!r}", flush=True)
    print(f"[train] iteration 1's {len(returns)} episodes: mean return "
          f"{mean!r} (se {se!r}) vs JAX's pooled rollout {want!r} (se "
          f"{want_se!r}): {delta!r} combined se; row mean "
          f"{rows[0][1]['episode_reward_mean']!r}", flush=True)
    _check(all(math.isfinite(v) for _, row in rows for v in row.values()),
           "a train metric is not finite")
    _check(moved > 0, "the parameters did not move")
    _check(all(row["pool_wraps"] == 0 for _, row in rows), "pool wraps")
    _check(result.state.steps == TRAIN_ITERS * n, "steps")
    _check(header == JAX_PROGRESS_COLUMNS, f"progress.csv columns {header}")
    _check(os.path.exists(os.path.join(result.run_dir, "params.json")),
           "params.json")
    _check(trainer.ckpt.all_steps() == list(range(1, TRAIN_ITERS + 1)),
           f"checkpoints kept: {trainer.ckpt.all_steps()}")
    _check(abs(rows[0][1]["episode_reward_mean"] - mean) <= 1e-4
           * max(1.0, abs(mean)), "episode accounting")
    _check(abs(delta) <= STEPPER_SE, "iteration 1's mean return")
    first_row = dict(rows[0][1])

    restored = trainer.restore()
    _check(restored.steps == TRAIN_ITERS * n, "restored steps")
    rows.clear()
    t_last[0] = time.perf_counter()
    result = trainer.run(TRAIN_MORE, state=restored,
                         on_iteration=on_iteration)
    _check([it for it, _ in rows] == list(
        range(TRAIN_ITERS + 1, TRAIN_ITERS + TRAIN_MORE + 1)),
        f"iterations after the restore: {[it for it, _ in rows]}")
    _check(result.state.steps == (TRAIN_ITERS + TRAIN_MORE) * n,
           "steps after the restore")
    _check(all(math.isfinite(v) for _, row in rows for v in row.values()),
           "a train metric after the restore is not finite")
    generate_rollouts(trainer, state=result.state)
    for name in ("components.pkl", "actions.pkl", "rectangle_pin.csv"):
        _check(os.path.exists(os.path.join(result.run_dir, name)),
               f"generate_rollouts wrote no {name}")
    peak = torch.cuda.max_memory_allocated() / 2**20 if cuda else None

    # one minibatch step of the last window, profiled
    batch = learner.flat_batch(windows[-1],
                               torch.zeros_like(windows[-1].value[0]))
    sel = torch.arange(learner.cfg.minibatch_size, device=learner.device)
    mb = {k: ({o: x[sel] for o, x in v.items()} if k == "obs" else v[sel])
          for k, v in batch.items()}
    learner.minibatch_step(result.state, mb, result.state.kl_coeff)
    _, launches, busy, wall = _profiled(lambda: learner.minibatch_step(
        result.state, mb, result.state.kl_coeff))
    trainer.close()

    it_s = float(np.mean(times["iteration"][1:]))
    roll_s = float(np.mean(times["rollout"][1:]))
    upd_s = float(np.mean(times["update"][1:]))
    steps = learner.cfg.num_sgd_iter * (n // learner.cfg.minibatch_size)
    print(f"[train] seconds an iteration (iterations 2-{TRAIN_ITERS} and "
          f"{TRAIN_ITERS + 1}): {times['iteration']!r}; rollout "
          f"{times['rollout']!r}; update {times['update']!r}", flush=True)
    print(f"[train] mean of iterations 2+: {it_s!r} s an iteration, rollout "
          f"{roll_s!r} s ({n / roll_s!r} env-steps/s, share "
          f"{roll_s / it_s!r}), update {upd_s!r} s ({steps / upd_s!r} Adam "
          f"steps/s, share {upd_s / it_s!r}); peak memory {peak!r} MB "
          f"(torch.cuda.max_memory_allocated); {_card()}", flush=True)
    if launches is None:
        print("[train] one minibatch step: not measured (the profiler "
              "recorded no device events)")
    else:
        print(f"[train] one minibatch step (128 transitions: train forward, "
              f"evaluate, loss, backward, Adam) profiled: {launches} kernel "
              f"launches, device busy {busy!r} ms of {wall!r} ms wall (busy "
              f"share {busy / wall!r})", flush=True)
    return it_s, roll_s, upd_s, n / roll_s, steps / upd_s, launches, \
        (busy / wall if launches else None), peak, first_row, root, \
        result.run_dir, logged


def phase_train_learns(device="cuda"):
    """[train learns]: tests/agent/test_ppo.py:174-193 on ``device``: the
    6x6 square env, ``PPOConfig(num_envs=32, unroll_length=16,
    minibatch_size=64, num_sgd_iter=8, lr=3e-4)``, ``LEARNS_ITERS``
    iterations; the mean of the last 5 beats the first 5 by more than 1.0
    and exceeds 7.5."""
    import numpy as np
    import torch
    from placement_tpu_torch.agent.policy import Policy, model_config_for
    from placement_tpu_torch.agent.ppo import PPOConfig, PPOLearner
    from placement_tpu_torch.env.types import EnvParams, Variant
    params = EnvParams(variant=Variant.SQUARE, height=6, width=6,
                       component_n=2)
    cfg = PPOConfig(num_envs=32, unroll_length=16, minibatch_size=64,
                    num_sgd_iter=8, lr=3e-4)
    learner = PPOLearner(params, Policy(
        params, model_config_for(params, "square"), device), cfg)
    state = learner.init(torch.Generator(device).manual_seed(0))
    t0 = time.perf_counter()
    rews = []
    for _ in range(LEARNS_ITERS):
        state, m = learner.train_step(state)
        rews.append(float(m["episode_reward_mean"]))
    dt = time.perf_counter() - t0
    first, last = float(np.mean(rews[:5])), float(np.mean(rews[-5:]))
    print(f"[train learns] 6x6 square, {LEARNS_ITERS} iterations in {dt!r} "
          f"s: first 5 {first!r}, last 5 {last!r} (need > first + 1.0 and "
          f"> 7.5); curve {[round(r, 3) for r in rews]}", flush=True)
    _check(last > first + 1.0 and last > 7.5, "PPO did not learn")
    return first, last


#: ``[learning curve]``: the flagship spatial preset, iterations at the
#: throughput preset's epochs, the iterations held to JAX's seed band
#: (``experiments/results/rectangle_spatial_pin_seed_sweep_sgd10.csv``, 3
#: seeds) widened by ``LC_MARGIN`` on each side
LC_TYPE, LC_ITERS, LC_SGD_ITER = "rectangle_spatial_pin", 30, 10
LC_CHECKS = (10, 20, 30)
LC_MARGIN = 0.10
LC_BAND_CSV = (REPO / "experiments" / "results"
               / "rectangle_spatial_pin_seed_sweep_sgd10.csv")


def _seed_band(path, iterations):
    """{iteration: (min, max)} of the episode reward over a committed
    seed sweep's seeds."""
    import csv
    per = {}
    with open(path, newline="") as f:
        for r in csv.DictReader(f):
            it = int(r["training_iteration"])
            if it in iterations:
                per.setdefault(it, []).append(
                    float(r["episode_reward_mean"]))
    return {it: (min(v), max(v)) for it, v in per.items()}


def phase_learning_curve(device="cuda"):
    """[learning curve]: the learning-curve runners' training on
    ``device``: ``seed_sweep``'s random-policy baseline (512 episodes,
    generator seed 1001) within ``STEPPER_SE`` combined standard errors of
    JAX ``simulate``'s (the fixture), then ``seed_sweep._train_once`` on
    the spatial flagship (seed 0, 128 boards x 32 steps, 10 epochs) for
    ``LC_ITERS`` iterations: every reward finite, and iterations
    ``LC_CHECKS`` inside JAX's seed band at 10 epochs, widened by
    ``LC_MARGIN``. Returns (seconds an iteration, {iteration: reward})."""
    import math
    import tempfile
    import torch
    from placement_tpu_torch.agent.random_policy import simulate
    from placement_tpu_torch.experiments import seed_sweep
    from placement_tpu_torch.utils.config import load_experiment
    want = json.loads(STEPPER_FIXTURE.read_text())[LC_TYPE]
    env_params, _, _ = load_experiment(LC_TYPE)
    ret = simulate(env_params, torch.Generator(device).manual_seed(
        seed_sweep.BASELINE_SEED), 512, device=device).double()
    mean, se = float(ret.mean()), float(ret.std() / len(ret) ** 0.5)
    both = math.hypot(se, want["se"])
    print(f"[learning curve] random-policy baseline {mean!r} (se {se!r}, "
          f"{len(ret)} episodes) vs JAX simulate {want['mean']!r} (se "
          f"{want['se']!r}): {(mean - want['mean']) / both!r} combined se",
          flush=True)
    _check(abs(mean - want["mean"]) <= STEPPER_SE * both,
           "[learning curve] random-policy baseline")
    band = _seed_band(LC_BAND_CSV, LC_CHECKS)
    root = tempfile.mkdtemp(prefix="chip_smoke_lc_")
    try:
        t0 = time.perf_counter()
        rows = seed_sweep._train_once(LC_TYPE, LC_ITERS, 0, 128, 32,
                                      num_sgd_iter=LC_SGD_ITER,
                                      device=device, results_root=root)
        dt = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rewards = [r["episode_reward_mean"] for r in rows]
    _check(len(rewards) == LC_ITERS
           and all(math.isfinite(x) for x in rewards),
           "[learning curve] rewards finite, one an iteration")
    at = {it: rewards[it - 1] for it in LC_CHECKS}
    card = _card() if torch.device(device).type == "cuda" else device
    print(f"[learning curve] {LC_TYPE}, seed 0, {LC_SGD_ITER} epochs: "
          f"{LC_ITERS} iterations in {dt!r} s, {dt / LC_ITERS!r} s an "
          f"iteration ({card}); "
          f"reward at {LC_CHECKS}: {[at[it] for it in LC_CHECKS]!r} vs JAX's "
          f"band {[band[it] for it in LC_CHECKS]!r} +- {LC_MARGIN}; curve "
          f"{[round(x, 3) for x in rewards]}", flush=True)
    for it in LC_CHECKS:
        lo, hi = band[it]
        _check(lo - LC_MARGIN <= at[it] <= hi + LC_MARGIN,
               f"[learning curve] iteration {it}: {at[it]!r} outside JAX's "
               f"band [{lo!r}, {hi!r}] +- {LC_MARGIN}")
    return dt / LC_ITERS, at


#: ``[train dp]``: iterations, and the six metrics JAX's sharded test holds
#: to the unsharded step (tests/parallel/test_mesh.py:83-88) at its
#: tolerance
DP_ITERS = 2
DP_METRICS = ("episode_reward_mean", "episodes_this_iter", "policy_loss",
              "vf_loss", "kl", "custom_metrics/normalized_wirelengths_mean")
DP_RTOL, DP_ATOL = 2e-3, 1e-5


def _collectives(prof):
    """(collectives issued, their host ms, their device ms, kernel
    launches, device busy ms) in a ``torch.profiler`` trace: the
    ``c10d::allreduce_`` calls, the NCCL kernels' time on the card (none
    over gloo, whose collectives run on the host), and all the kernels."""
    import torch
    calls = [e for e in prof.events() if e.name == "c10d::allreduce_"]
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    return (len(calls), sum(e.cpu_time_total for e in calls) / 1e3,
            sum(e.device_time_total for e in nccl) / 1e3, len(kernels),
            sum(e.device_time_total for e in kernels) / 1e3)


def _dp_ratios(got, want):
    """Each ``DP_METRICS`` value's |got - want| over its allowance,
    rtol * |want| + atol: at most 1 passes."""
    return {k: abs(got[k] - want[k]) / (DP_RTOL * abs(want[k]) + DP_ATOL)
            for k in DP_METRICS}


def _world_one_iteration(device="cuda"):
    """Iteration 1 of ``[train]``'s setup (the flagship, the fixture's
    weights, the default ``PPOConfig``, seed 0) in a new ``Trainer``: its
    metrics row."""
    import tempfile
    from placement_tpu_torch.agent.trainer import Trainer
    rows = []
    root = tempfile.mkdtemp(prefix="chip_smoke_world1_")
    try:
        trainer = Trainer("rectangle_pin", results_root=root, device=device,
                          run_name="PPO_rectangle_pin_world1",
                          use_tensorboard=False)
        try:
            trainer.run(1, state=trainer.init_state(
                0, flax_variables=_fixture_variables()),
                on_iteration=lambda it, row: rows.append(dict(row)))
        finally:
            trainer.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rows[0]


def world_one_noise(runs=2, deterministic=False, device="cuda"):
    """World 1's own run-to-run noise, the measurement behind
    ``_deterministic``: ``[train]``'s iteration 1 ``runs`` times in this
    process, with PyTorch's defaults or deterministic; prints each
    ``DP_METRICS`` value's relative difference from the first run and its
    ratio to ``[train dp]``'s allowance, and whether every metric of the
    rows is bitwise equal. Returns the rows."""
    cm = _deterministic() if deterministic else contextlib.nullcontext()
    with cm:
        rows = [_world_one_iteration(device) for _ in range(runs)]
    first = rows[0]
    for i, row in enumerate(rows[1:], 2):
        rel = {k: abs(row[k] - first[k]) / max(abs(first[k]), 1e-30)
               for k in DP_METRICS}
        same = all(row[k] == first[k] for k in first if k != "time_total_s")
        print(f"[world 1 noise] deterministic {deterministic}: run {i} vs "
              f"run 1: relative difference {rel!r}; over [train dp]'s "
              f"allowance {_dp_ratios(row, first)!r}; every metric bitwise "
              f"equal: {same}; {_card()}", flush=True)
    return rows


@_deterministic()
def _train_dp_rank(rank, world, root, variables, device="cuda"):
    """One rank of ``[train dp]`` (a ``mesh.spawn_ranks`` worker):
    ``Trainer("rectangle_pin", mesh=make_mesh(world))``, the default
    ``PPOConfig``, the fixture's weights, seed 0, ``DP_ITERS`` iterations;
    then the parameters held bitwise equal across the ranks
    (``mesh.replicated``) and one more minibatch step of this rank's block,
    profiled on rank 0. TF32 off, as ``phase_device`` sets it; under
    ``_deterministic``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from placement_tpu_torch.agent.trainer import Trainer
    from placement_tpu_torch.parallel import mesh
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    m = mesh.make_mesh(world, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    trainer = Trainer("rectangle_pin", results_root=root, mesh=m,
                      run_name="PPO_rectangle_pin_dp", use_tensorboard=False)
    learner = trainer.learner
    times = {"rollout": [], "update": [], "iteration": []}
    windows = []
    rollout = _timed(times, "rollout", learner.rollout, m.device)

    def rollout_kept(state):
        out = rollout(state)
        windows.append(out[1])
        return out

    learner.rollout = rollout_kept
    learner.update = _timed(times, "update", learner.update, m.device)
    rows = []
    t_last = [time.perf_counter()]

    def on_iteration(it, row):
        now = time.perf_counter()
        times["iteration"].append(now - t_last[0])
        t_last[0] = now
        rows.append(row)

    state = trainer.init_state(0, flax_variables=variables)
    t_last[0] = time.perf_counter()
    result = trainer.run(DP_ITERS, state=state, on_iteration=on_iteration)
    state = result.state
    check = mesh.replicated(m)
    for v in state.model.state_dict().values():
        check(v)
    peak = torch.cuda.max_memory_allocated(m.device) / 2**20 if cuda else None

    # one more minibatch step: this rank's block of the last window's first
    # minibatch; warmed up, then profiled on rank 0 (every rank steps: the
    # collectives meet)
    batch = learner.flat_batch(windows[-1],
                               torch.zeros_like(windows[-1].value[0]))
    block = learner.cfg.minibatch_size // world
    sel = torch.arange(rank * block, (rank + 1) * block, device=m.device)
    mb = {k: ({o: x[sel] for o, x in v.items()} if k == "obs" else v[sel])
          for k, v in batch.items()}

    def step():
        learner.minibatch_step(state, mb, state.kl_coeff)
        if cuda:
            torch.cuda.synchronize()

    step()
    profiled = None
    if rank == 0:
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
            t0 = time.perf_counter()
            step()
            wall = (time.perf_counter() - t0) * 1e3
        profiled = (*_collectives(prof), wall)
    else:
        step()
    trainer.close()
    return {"rows": rows, "times": times, "peak_mb": peak,
            "profiled": profiled, "device": str(m.device)}


def phase_train_dp(train, device="cuda"):
    """[train dp]: first world 1's iteration 1 again, every metric bitwise
    ``[train]``'s (``train``: its results), so that the worlds differ by
    the sharding alone; then ``[train]``'s setup (the flagship, the
    fixture's weights, the default ``PPOConfig``, seed 0) over ``world``
    ranks, each in a ``Trainer(mesh=...)``, all under ``_deterministic``:
    ``min(4, device_count)`` ranks over NCCL on a machine with 2 or more
    cards, else 2 ranks sharing the card over gloo; ``DP_ITERS``
    iterations. Iteration 1's ``DP_METRICS`` equal ``[train]``'s within
    rtol 2e-3 and atol 1e-5, the parameters bitwise equal across the ranks
    after iteration 2, no pool wraps. Returns (world, backend, env-steps/s
    of all ranks, per card, seconds an iteration, each metric's |diff| /
    allowance)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from placement_tpu_torch.agent.ppo import PPOConfig
    from placement_tpu_torch.parallel import mesh
    cards = torch.cuda.device_count() if device == "cuda" else 1
    world = min(4, cards) if cards >= 2 else 2
    backend = mesh.backend_for(device, world)
    used = min(world, cards)
    print(f"[train dp] {world} ranks over {backend} on {used} card(s)",
          flush=True)
    # world 1 again: bitwise [train]'s, so the worlds differ by the
    # sharding alone
    with _deterministic():
        again = _world_one_iteration(device)
    moved = {k: (again[k], train[8][k]) for k in train[8]
             if k != "time_total_s" and again[k] != train[8][k]}
    print(f"[train dp] world 1 again, iteration 1: every metric bitwise "
          f"[train]'s: {not moved}", flush=True)
    _check(not moved, f"[train dp] world 1 is not reproducible: (again, "
                      f"[train]) {moved!r}")
    root = tempfile.mkdtemp(prefix="chip_smoke_train_dp_")
    try:
        ranks = mesh.spawn_ranks(
            _train_dp_rank, world,
            args=(root, _fixture_variables(), device), backend=backend,
            timeout=900)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = train[8]
    got = ranks[0]["rows"][0]
    pairs = {k: (got[k], want[k]) for k in DP_METRICS}
    ratios = _dp_ratios(got, want)
    print(f"[train dp] iteration 1 vs [train]'s (world 1), (world "
          f"{world}, world 1): {pairs!r}; |diff| / (rtol * |world 1| + "
          f"atol) {ratios!r} (rtol {DP_RTOL}, atol {DP_ATOL})", flush=True)
    _check(all(r <= 1.0 for r in ratios.values()),
           f"[train dp] iteration 1 differs from world 1: (world {world}, "
           f"world 1) {pairs!r}; |diff| / allowance {ratios!r}")
    _check(all(row["pool_wraps"] == 0 for res in ranks
               for row in res["rows"]), "[train dp] pool wraps")
    drop = "time_total_s"
    _check(all([{k: v for k, v in r.items() if k != drop}
                for r in res["rows"]] ==
               [{k: v for k, v in r.items() if k != drop}
                for r in ranks[0]["rows"]] for res in ranks),
           "[train dp] the ranks' metrics differ")
    n = PPOConfig().train_batch
    it_s = max(float(np.mean(res["times"]["iteration"][1:]))
               for res in ranks)
    for r, res in enumerate(ranks):
        t = res["times"]
        print(f"[train dp] rank {r} ({res['device']}): seconds an iteration "
              f"{t['iteration']!r}; rollout {t['rollout']!r}; update "
              f"{t['update']!r}; peak memory {res['peak_mb']!r} MB",
              flush=True)
    calls, host_ms, dev_ms, launches, busy, wall = ranks[0]["profiled"]
    rate = n / it_s
    print(f"[train dp] iteration 2: {it_s!r} s (slowest rank), "
          f"{rate!r} env-steps/s for all ranks, {rate / used!r} per card; "
          f"world 1 ([train], iterations 2+): {train[0]!r} s, "
          f"{n / train[0]!r} env-steps/s; {_card()}", flush=True)
    print(f"[train dp] one minibatch step on rank 0 (its block of "
          f"{PPOConfig().minibatch_size // world} rows), profiled: {calls} collectives "
          f"(c10d::allreduce_), {host_ms!r} ms of host time in them, "
          f"{dev_ms!r} ms of NCCL kernels on the card, of {wall!r} ms wall "
          f"(collectives' host share {host_ms / wall!r}); {launches} kernel "
          f"launches, the card busy {busy!r} ms", flush=True)
    return world, backend, rate, rate / used, it_s, ratios


def train_dp_repeats(n=10, device="cuda"):
    """``[train]`` once, then ``[train dp]`` ``n`` times against it (each
    raises where it fails); prints each metric's worst |diff| / allowance
    over the repeats."""
    train = phase_train(device)
    try:
        ratios = [phase_train_dp(train, device)[5] for _ in range(n)]
    finally:
        shutil.rmtree(train[9], ignore_errors=True)
    worst = {k: max(r[k] for r in ratios) for k in DP_METRICS}
    print(f"[train dp x{n}] all {n} passed; worst |diff| / (rtol * |world "
          f"1| + atol) per metric {worst!r}; {_card()}", flush=True)
    return worst


# ---------------------------------------------------------------------------
# The model zoo's repaired settings, the runners, the profilers, the web app
# ---------------------------------------------------------------------------

#: Flax init variables, 64 JAX observations and JAX's outputs of the zoo's
#: two repaired settings (recorded by ``PYTHONPATH=. JAX_PLATFORMS=cpu
#: python tests/test_torch_zoo_component_grid.py``)
ZOO_FIXTURE = FIXTURES / "torch_zoo_edges.npz"
#: the random-policy runners at 1024 episodes: (module, flags, the
#: ``STEPPER_FIXTURE`` config those flags give)
RUNNER_EPISODES = 1024
RUNNERS = (
    ("run_policy_square", [], "square"),
    ("run_policy_rectangular", [], "rectangle"),
    ("run_policy_rectangular_pin", [], "varpin_web"),
    ("run_policy_rectangular_pin",
     ["--spatial", "--min_num_pins_per_net", "6", "--weight_wirelength",
      "0.75", "--weight_num_intersections", "0.25"],
     "rectangle_spatial_pin"),
)
#: the profilers' flags in this run: every size the JAX tool's default, a
#: short timing window each
TRAIN_PROFILE_ARGS = ["--components", "--budget-s", "1"]
POOLED_PROFILE_ARGS = ["--budget-s", "2"]
PRICE_ARGS = ["--budget-s", "2"]


def _zoo_policy(data, name, device):
    """(policy, observations) of the fixture's setting ``name`` on
    ``device``, its Flax weights carried in through ``Policy``."""
    import dataclasses
    import torch
    from placement_tpu_torch.agent.policy import Policy
    from placement_tpu_torch.models import convert
    from placement_tpu_torch.utils.config import load_experiment
    model_type, overrides = json.loads(str(data["meta"]))[name]
    params, cfg, _ = load_experiment(model_type)
    n = len(name) + 5
    variables = convert.unflatten({k[n:]: v for k, v in data.items()
                                   if k.startswith(f"{name}/var/")})
    policy = Policy(params, dataclasses.replace(cfg, **overrides),
                    device).load_flax(variables)
    obs = {k[n:]: torch.as_tensor(v, device=device)
           for k, v in data.items() if k.startswith(f"{name}/obs/")}
    return policy, obs


def phase_zoo_edges(device="cuda"):
    """[zoo edges]: the zoo's two repaired settings on the card, from the
    fixture's Flax weights: the flagship with 3 conv blocks of kernel 5
    (the grid encoder's map empties) and the spatial preset with a
    max-pooled component grid (its width from the env's component sides).
    Eval logits and value within ``POLICY_RTOL`` of the same model on the
    CPU (TF32 off, ``phase_device``); one train-mode ``evaluate`` (the
    greedy actions, the CPU's logits as the behaviour): its outputs finite
    and within ``POLICY_RTOL`` of the CPU's, its batch statistics NaN
    exactly where the CPU's are and the others within ``POLICY_RTOL``.
    Returns the worst relative error."""
    import numpy as np
    import torch
    from placement_tpu_torch.models import convert
    data = dict(np.load(ZOO_FIXTURE))
    worst = 0.0
    for name, (model_type, overrides) in json.loads(
            str(data["meta"])).items():
        card, obs = _zoo_policy(data, name, device)
        cpu, cpu_obs = _zoo_policy(data, name, "cpu")
        with torch.no_grad():
            got, want = card.model(obs), cpu.model(cpu_obs)
        eval_err = max(_rel_err(got[k].cpu(), want[k])
                       for k in ("logits", "value"))
        jax_err = max(_rel_err(want[k], data[f"{name}/{k}"])
                      for k in ("logits", "value"))
        act = cpu.act(cpu_obs, torch.Generator(), deterministic=True)[0]
        out = card.evaluate(obs, act.to(device), want["logits"].to(device),
                            torch.Generator(device))
        ref = cpu.evaluate(cpu_obs, act, want["logits"], torch.Generator())
        _check(all(bool(torch.isfinite(t).all()) for t in out),
               f"[zoo edges] {name}: a train-mode output is not finite")
        train_err = max(_rel_err(g.detach().cpu(), w.detach())
                        for g, w in zip(out, ref))
        g_sd = convert.to_flax(card.model.state_dict())
        w_sd = convert.to_flax(cpu.model.state_dict())
        nan, stats_err = [], 0.0
        for k in sorted(k for k in w_sd if k.startswith("batch_stats/")):
            _check(np.array_equal(np.isnan(g_sd[k]), np.isnan(w_sd[k])),
                   f"[zoo edges] {name}: NaN statistics differ at {k}")
            if np.isnan(w_sd[k]).all():
                nan.append(k[len("batch_stats/"):])
            finite = ~np.isnan(w_sd[k])
            if finite.any():
                stats_err = max(stats_err, _rel_err(g_sd[k][finite],
                                                    w_sd[k][finite]))
        heads = {n: tuple(m.weight.shape) for n, m in
                 card.model.named_children() if n in ("logits_head",)}
        print(f"[zoo edges] {name} ({model_type}, {overrides}): heads "
              f"{heads}, {len(obs['grid'])} boards: eval card vs CPU rel "
              f"err {eval_err!r} (CPU vs JAX {jax_err!r}); train-mode "
              f"evaluate outputs finite, rel err {train_err!r}; statistics "
              f"NaN where the CPU's are ({nan or 'none'}), the others rel "
              f"err {stats_err!r} (tolerance {POLICY_RTOL}, TF32 off)",
              flush=True)
        _check(max(eval_err, train_err, stats_err) <= POLICY_RTOL
               and jax_err <= POLICY_RTOL,
               f"[zoo edges] {name}: card != CPU")
        _check((name == "flagship_empty") == bool(nan),
               f"[zoo edges] {name}: NaN statistics {nan}")
        worst = max(worst, eval_err, train_err, stats_err)
    return worst


def phase_runners(device="cuda"):
    """[runners]: each random-policy runner's ``run()`` on ``device`` with
    ``RUNNER_EPISODES`` episodes (its other flags at their defaults, or
    those of a fixture config): the flags give the fixture's config, the
    mean return sits within ``STEPPER_SE`` combined standard errors of JAX
    ``simulate``'s; env-steps/s = boards x steps / seconds (the card synced
    by the read of the returns). Returns {config: env-steps/s}."""
    import importlib
    import math
    import torch
    rates = {}
    cuda = torch.device(device).type == "cuda"
    for module, flags, config in RUNNERS:
        mod = importlib.import_module(
            f"placement_tpu_torch.experiments.random_policy.{module}")
        args = mod.parser().parse_args(
            flags + ["--n_episodes", str(RUNNER_EPISODES)]
            + ([] if cuda else ["--device", device]))
        params, want = _stepper_params(config)
        _check(mod.params_from(args) == params,
               f"[runners] {module} {flags}: not the {config} config")
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        returns = mod.run(args)
        dt = time.perf_counter() - t0
        _check(tuple(returns.shape) == (RUNNER_EPISODES,)
               and returns.device.type == torch.device(device).type
               and bool(torch.isfinite(returns).all()),
               f"[runners] {module}: returns")
        r = returns.double()
        mean, se = float(r.mean()), float(r.std() / RUNNER_EPISODES ** 0.5)
        both = math.hypot(se, want["se"])
        boards = min(RUNNER_EPISODES, 256)       # simulate's default batch
        rates[config] = boards * (params.area + 2) / dt
        print(f"[runners] {module} {' '.join(flags)} ({config}): mean "
              f"return {mean!r} (se {se!r}) vs JAX {want['mean']!r} (se "
              f"{want['se']!r}): {(mean - want['mean']) / both!r} combined "
              f"se; {dt!r} s, {rates[config]!r} env-steps/s ({boards} "
              f"boards x {params.area + 2} steps); "
              f"{_card() if cuda else device}", flush=True)
        _check(abs(mean - want["mean"]) <= STEPPER_SE * both,
               f"[runners] {module}: mean return")
    return rates


def phase_profiles(device="cuda"):
    """[profiles]: ``tools/train_profile`` (the flagship, 1 / 10 / 30
    epochs, with the rollout's pieces), ``tools/pooled_profile`` (the web
    app's maximum) and ``tools/price_exact_sampling`` (the flagship and
    the web app's maximum) on the card, each writing its JSON into a
    temporary directory: every number finite, the card's name and power
    limit and the ``reduced`` list in each. Returns the three results."""
    import math
    import tempfile
    from placement_tpu_torch.tools import (
        pooled_profile, price_exact_sampling, train_profile)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_profiles_")
    card = _card() if device == "cuda" else None
    out = {}
    try:
        for name, module, argv in (
                ("train_profile", train_profile, TRAIN_PROFILE_ARGS),
                ("pooled_profile", pooled_profile, POOLED_PROFILE_ARGS),
                ("price_exact_sampling", price_exact_sampling, PRICE_ARGS)):
            t0 = time.perf_counter()
            path = pathlib.Path(tmp, f"{name}.json")
            result = module.main(argv + ["--out", str(path), "--device",
                                         device])
            _check(json.loads(path.read_text()) == json.loads(
                json.dumps(result)), f"[profiles] {name}: its JSON file")
            _check(result.get("card") == card and "reduced" in result,
                   f"[profiles] {name}: card {result.get('card')!r}")
            stack = [result]
            while stack:
                node = stack.pop()
                for v in node.values():
                    if isinstance(v, dict):
                        stack.append(v)
                    elif isinstance(v, float):
                        _check(math.isfinite(v), f"[profiles] {name}: "
                                                 "a number is not finite")
            out[name] = result
            seconds = time.perf_counter() - t0
            print(f"[profiles] {name} {' '.join(argv)}: {seconds!r} s",
                  flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tp, pp, pe = (out["train_profile"]["phases"], out["pooled_profile"],
                  out["price_exact_sampling"]["configs"])
    mb = out["train_profile"]["minibatch_step"]
    print(f"[profiles] train_profile: rollout+GAE {tp['rollout_gae_ms']!r} "
          f"ms (observe {tp['obs_only_ms']!r}, forward "
          f"{tp['policy_forward_only_ms']!r}, env step "
          f"{tp['env_step_only_ms']!r} ms a window); train_step sgd 1 / 10 "
          f"/ 30: {tp['train_step_sgd1_ms']!r} / {tp['train_step_sgd10_ms']!r}"
          f" / {tp['train_step_sgd30_ms']!r} ms; per epoch "
          f"{out['train_profile']['derived']['sgd_ms_per_epoch']!r} ms; a "
          f"minibatch step {mb['launches']} launches, the card busy "
          f"{mb['device_busy_ms']!r} of {mb['wall_ms']!r} ms; {card}",
          flush=True)
    print(f"[profiles] pooled_profile ({pp['batch']} boards, pool "
          f"{pp['pool_size']}, {pp['inner']} steps): "
          + "; ".join(f"{k} {v['steady_s_per_call']!r} s a call"
                      + (f" ({v['steps_per_sec']!r} env-steps/s)"
                         if "steps_per_sec" in v else
                         f" ({v['us_per_board']!r} us a board)")
                      for k, v in pp["phases"].items())
          + f"; reduced {pp['reduced']}; {card}", flush=True)
    print("[profiles] price_exact_sampling: " + "; ".join(
        f"{k} ({v['batch']} boards): generation {v['gen_fast_us_per_board']!r}"
        f" -> {v['gen_exact_us_per_board']!r} us a board "
        f"({v['gen_slowdown_x']!r}x), rollout "
        f"{v['rollout_fast_steps_per_sec']!r} -> "
        f"{v['rollout_exact_steps_per_sec']!r} env-steps/s "
        f"({v['rollout_slowdown_x']!r}x)" for k, v in pe.items())
        + f"; {card}", flush=True)
    return out


def phase_webapp(train):
    """[webapp]: ``webapp/data.py`` over the results root that ``[train]``
    wrote: ``list_runs`` finds its one run, ``load_run`` gives it the
    iterations, the last mean return, the model type and the rollouts that
    Trainer logged and exported, and ``comparison_curves`` every logged
    value of the curves' columns."""
    import os
    from placement_tpu_torch.webapp.data import (
        CURVE_COLUMNS, comparison_curves, list_runs, load_run)
    root, run_dir, logged = train[9], train[10], train[11]
    runs = list_runs(root)
    _check([r.path for r in runs] == [run_dir],
           f"[webapp] runs {[r.path for r in runs]}")
    run = load_run(run_dir)
    _check(run.num_iterations == len(logged)
           and run.final_reward_mean == logged[-1]["episode_reward_mean"]
           and run.model_type == "rectangle_pin" and run.has_rollouts
           and run.input_params, f"[webapp] load_run: {run}")
    curves = comparison_curves([run_dir])[os.path.basename(run_dir)]
    _check(list(curves["training_iteration"])
           == [float(i) for i in range(1, len(logged) + 1)],
           "[webapp] training_iteration")
    for col in CURVE_COLUMNS:
        _check(list(curves[col]) == [row[col] for row in logged],
               f"[webapp] curve {col}")
    print(f"[webapp] list_runs / load_run / comparison_curves over "
          f"[train]'s run: {run.name}, {run.num_iterations} iterations, "
          f"final episode_reward_mean {run.final_reward_mean!r}, rollouts "
          f"{run.has_rollouts}; the {len(CURVE_COLUMNS)} curves equal the "
          f"Trainer's logged rows", flush=True)
    return run.num_iterations


def main():
    t_main = time.perf_counter()
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
    phase_batch_scaling(*_row("rect"))
    # every kernel with a partial CUDA block
    partial_err = {
        fr.kernel_name(_row(row)[0]): phase_kernel_vs_plain(
            f"{row} partial block", _row(row)[0], PARTIAL_BLOCK,
            batch=PARTIAL_BATCH)[0]
        for row in PARTIAL_ROWS}
    for label, (row, overrides) in REDUCED_SHAPES.items():
        params, block = _row(row)
        kernel = fr.kernel_name(params)
        partial_err[kernel] = max(partial_err[kernel], phase_kernel_vs_plain(
            label, params.replace(**overrides), block, batch=SHAPE_BATCH,
            timed=False)[0])
    # the beam at its capacity width
    params, block = _row("pin_beam")
    err4, ms4, plain4, *_ = phase_kernel_vs_plain(
        "pin_beam bw=4", params.replace(reward_beam_width=4), block)
    for config, block in VARPIN.items():
        results[config] = phase_kernel_vs_plain(
            config, _golden_params(goldens[config]), block)
        phase_reward_split(config, _golden_params(goldens[config]), block)
    # the general instantiations, on the edges of the JAX kernel's envelope
    t_env = time.perf_counter()
    envelope = phase_envelope()
    print(f"[envelope] {time.perf_counter() - t_env!r} s for the phase")
    wide = phase_wide()
    wide_beam = phase_wide_beam()
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
    launches, rows = phase_matrix(ref_means)
    for row in ("square", "rect"):
        print(f"[matrix] {row}: {rows[row]['steps_per_sec']!r} env-steps/s "
              f"vs {BATCH} x {STEPS} / kernel ms "
              f"{BATCH * STEPS / results[row][1] * 1e3!r}: a call takes "
              f"{BATCH * STEPS / rows[row]['steps_per_sec'] * 1e3!r} ms of "
              f"wall time, the kernel {results[row][1]!r} ms of it; the "
              f"rest is the host's enqueue")
    launches["centroid"] += launches_1       # main path 1 runs it too
    web = goldens["varpin_web"]
    pen = fr._penalty(_golden_params(web))
    launches["varpin"], rate3 = phase_sharded(
        _golden_params(web), VARPIN["varpin_web"],
        (web["reward_sum"] - web["batch"] * pen)
        / (web["done_count"] - web["batch"]))
    # the general stepper: eager PyTorch, no kernel of its own; then the
    # kernel from its reset boards, and the dry run from reset boards
    gen = torch.Generator("cuda").manual_seed(2024)
    stepper_rate = phase_stepper(gen)
    family_rates = phase_stepper_families(gen)
    card_cpu_err = phase_stepper_card_cpu(gen)
    reset_err = {}
    for name, block in RESET_KERNEL.items():
        kernel = "centroid" if name == "flagship" else "varpin"
        n, reset_err[kernel] = phase_reset_kernel(name, block, gen)
        launches[kernel] += n
    launches["varpin"] += phase_dryrun()
    # the policy path: models, Policy.act and the pooled engine (no kernel
    # of its own; counts of the fused kernels stay as they are)
    forward_ms = phase_policy(gen)
    policy_out = phase_policy_rollout(gen)
    pooled_out = phase_pooled(gen)
    web_max_rate = phase_matrix_pooled()
    phase_entry()
    # the learner (no kernel of its own): [learner], the [train] main path
    # and [train learns]
    t_learn = time.perf_counter()
    learner_err = phase_learner()
    t_zoo = time.perf_counter()
    zoo_learner = phase_zoo_learner()
    t_zoo = time.perf_counter() - t_zoo
    train = phase_train()
    learns = phase_train_learns()
    t_learn = time.perf_counter() - t_learn
    # the learning-curve runners' training on the spatial flagship
    curve = phase_learning_curve()
    # the data-parallel learner (parallel/mesh.py): [train] over ranks
    train_dp = phase_train_dp(train)
    # the zoo's repaired settings, the runners, the profilers and the web
    # app's data layer over [train]'s run (no kernel of their own)
    t_tools = time.perf_counter()
    try:
        zoo_err = phase_zoo_edges()
        runner_rates = phase_runners()
        profiles = phase_profiles()
        phase_webapp(train)
    finally:
        shutil.rmtree(train[9], ignore_errors=True)
    t_tools = time.perf_counter() - t_tools
    # no one PyTorch call computes a chunk: library_ms is null
    entries = []
    for k, (row, *_, replaces) in KERNELS.items():
        err, ms, plain_ms, bound_ms, bound_by = results[row]
        err = max(err, partial_err.get(k, 0.0), reset_err.get(k, 0.0))
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
    # the general instantiations: the representative edge's numbers, the
    # launches of every edge's matrix row, the largest error of its edges
    for k, rep in GENERAL_ROWS.items():
        _, err, ms, plain_ms, bound_ms, bound_by, _ = envelope[rep]
        replaces = KERNELS[k][-1]
        edges = [v for v in envelope.values() if v[0] == k]
        entries.append({
            "name": f"fused_rollout_{k}_general",
            "route": "cuda",
            "source": SOURCES[k],
            "replaces": f"placement_tpu/ops/fused_rollout.py:866 "
                        f"({replaces}; nets > 8, pins per net > 16 or a "
                        f"side > 32)",
            "launches": sum(v[-1] for v in edges),
            "max_abs_err": max(v[1] for v in edges),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })
    # the wide instantiation of the centroid kernel, on web_max
    err, ms, plain_ms, bound_ms, bound_by, wide_launches = wide
    entries.append({
        "name": "fused_rollout_centroid_wide",
        "route": "cuda",
        "source": SOURCES["centroid"],
        "replaces": f"placement_tpu/ops/fused_rollout.py:866 "
                    f"({KERNELS['centroid'][-1]}; components > 8, pins > "
                    f"48 or pins per component > 16, outside the JAX "
                    f"kernel's envelope)",
        "launches": wide_launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    })
    # the wide instantiations of the beam and "both" kernels, on web_max at
    # width 4 (the "both" error the larger of widths 2 and 4)
    for k in ("beam", "both"):
        err, ms, plain_ms, bound_ms, bound_by, _ = wide_beam[f"{k}4"]
        entries.append({
            "name": f"fused_rollout_{k}_wide",
            "route": "cuda",
            "source": SOURCES[k],
            "replaces": f"placement_tpu/ops/fused_rollout.py:866 "
                        f"({KERNELS[k][-1]}; components > 8, pins > 48 or "
                        f"pins per component > 16, outside the JAX "
                        f"kernel's envelope)",
            "launches": sum(v[-1] for key, v in wide_beam.items()
                            if key.startswith(k)),
            "max_abs_err": max(v[0] for key, v in wide_beam.items()
                               if key.startswith(k)),
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
        "max_abs_err": max(err, results["varpin_parity"][0],
                           reset_err["varpin"]),
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
    print(f"[stepper] flagship {stepper_rate!r} env-steps/s; others "
          f"{family_rates!r}; card == cpu worst reward/info diff "
          f"{card_cpu_err!r}")
    print(f"[policy path] forward {forward_ms!r} ms at {BATCH} boards; "
          f"policy rollout {policy_out[0]!r} env-steps/s, {policy_out[1]} "
          f"launches a step; pooled random {pooled_out[0]!r} env-steps/s, "
          f"{pooled_out[1]} launches a step, gated vs ungated largest diff "
          f"{pooled_out[4]!r}; eager simulate {stepper_rate!r}; "
          f"web_max_pooled {web_max_rate!r} env-steps/s")
    print(f"[learner path] {t_learn!r} s for [learner], [train] and "
          f"[train learns]; card vs CPU worst rel err {learner_err!r}; "
          f"[train] {train[0]!r} s an iteration (rollout {train[1]!r}, "
          f"update {train[2]!r}), {train[3]!r} env-steps/s in the rollout, "
          f"{train[4]!r} Adam steps/s, {train[5]} launches a minibatch step "
          f"(busy share {train[6]!r}), peak {train[7]!r} MB; [train learns] "
          f"first 5 {learns[0]!r}, last 5 {learns[1]!r}")
    print(f"[zoo learner] {t_zoo!r} s for {len(zoo_learner)} presets: "
          f"(card vs CPU worst rel err, one iteration's s, peak MB) "
          f"{zoo_learner!r}")
    print(f"[learning curve] {curve[0]!r} s an iteration at {LC_SGD_ITER} "
          f"epochs; reward at iterations {LC_CHECKS}: "
          f"{[curve[1][it] for it in LC_CHECKS]!r}")
    print(f"[train dp] {train_dp[0]} ranks over {train_dp[1]}: "
          f"{train_dp[2]!r} env-steps/s in all, {train_dp[3]!r} per card, "
          f"{train_dp[4]!r} s an iteration; |diff| / allowance "
          f"{train_dp[5]!r}")
    slowdown = {k: v["rollout_slowdown_x"] for k, v in
                profiles["price_exact_sampling"]["configs"].items()}
    print(f"[tools] {t_tools!r} s for [zoo edges], [runners], [profiles] "
          f"and [webapp]: zoo card vs CPU worst rel err {zoo_err!r}; "
          f"runners {runner_rates!r} env-steps/s; exact sampling "
          f"{slowdown!r} x the rollout's time")
    print(f"[chip_smoke] {time.perf_counter() - t_main!r} s in all; "
          f"{_card()}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
