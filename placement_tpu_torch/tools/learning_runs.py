"""Several learning-curve runs at once on the card(s), one process a run.

A PPO update leaves the card mostly idle (its time goes to the host's
dispatch), so independent runs can share a card. This tool starts one
runner process (``experiments.learning_curve`` or
``experiments.seed_sweep``) per model type, at most ``--per-card`` at a
time on each card (``CUDA_VISIBLE_DEVICES``), and queues the rest; each
process gets the host's cores divided by the runs at once as intra-op
threads. Each run writes ``<type><tag>.log`` and the runner's own files
under ``--out-dir``, and its run dirs under
``--results-root/<type><tag>/``. The runner's last JSON line, with the
layout, the card's name and power limit (``nvidia-smi``), the wall
seconds and the seconds an iteration (the slope of this run's
``time_total_s``), goes into ``<type><tag>_summary.json``.

    python -m placement_tpu_torch.tools.learning_runs \\
        --types rectangle_factorized_pin rectangle_factorized \\
        --per-card 2 --tag _h100 --out-dir build/lc \\
        --results-root build/runs -- --iterations 150

Arguments after ``--`` go to every runner. ``--resume`` skips a type
whose summary exists and goes on from a cut run: ``learning_curve
--restore <its newest run dir>`` (a run cut twice does not go on: its
newest dir holds only the second part's rows) or ``seed_sweep
--resume``. ``--deadline-s`` stops the runs still going after that many
seconds; their checkpoints stay for ``--resume``. Prints one JSON line:
every run's type, card, layout, exit code, wall seconds and seconds an
iteration. ``--plot-only`` trains nothing: it draws each type's figure
from its table and summary in ``--out-dir`` (on a host with matplotlib,
where the card's machine has none).
"""

import argparse
import csv
import json
import os
import subprocess
import sys
import time

RUNNERS = {"learning_curve": "placement_tpu_torch.experiments.learning_curve",
           "seed_sweep": "placement_tpu_torch.experiments.seed_sweep"}


def _card(device: str, index: int):
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    if device != "cuda":
        return device
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[index].strip()


def _last_json(path: str):
    """The last line of a log that parses as a JSON object, or None."""
    with open(path, errors="replace") as f:
        lines = f.read().splitlines()
    for line in reversed(lines):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                continue
    return None


def seconds_per_iteration(run_dir: str):
    """The slope of ``time_total_s`` over a run dir's progress.csv
    (iterations 2 on: the first one holds the warm-up), or None."""
    try:
        with open(os.path.join(run_dir, "progress.csv"), newline="") as f:
            t = [float(r["time_total_s"]) for r in csv.DictReader(f)]
    except (OSError, KeyError, ValueError):
        return None
    return (t[-1] - t[0]) / (len(t) - 1) if len(t) >= 2 else None


def _runner_args(args, model_type, root):
    """The runner's command line for one type."""
    from placement_tpu_torch.agent.trainer import latest_run_dir
    cmd = [sys.executable, "-m", RUNNERS[args.runner], "--type", model_type,
           "--tag", args.tag, "--out-dir", args.out_dir,
           "--results-root", root, "--device", args.device, *args.rest]
    if args.resume and os.path.isdir(os.path.join(root, "PPO")):
        if args.runner == "seed_sweep":
            cmd.append("--resume")
        else:
            try:
                last = latest_run_dir(model_type, root)
            except FileNotFoundError:
                last = None
            ckpts = os.path.join(last or "", "checkpoints")
            if last and os.path.isdir(ckpts) and os.listdir(ckpts):
                cmd += ["--restore", last]
    return cmd


def plot(args) -> list:
    """Each type's runner figure drawn from its table and summary in
    ``--out-dir``; returns the PNGs."""
    from placement_tpu_torch.experiments import learning_curve, seed_sweep
    pngs = []
    for model_type in args.types:
        stem = os.path.join(args.out_dir, f"{model_type}{args.tag}")
        with open(f"{stem}_summary.json") as f:
            baseline = json.load(f)["random_baseline_reward"]
        if args.runner == "seed_sweep":
            png = os.path.join(args.out_dir,
                               f"{model_type}_seed_band{args.tag}.png")
            seed_sweep.plot_seed_band(seed_sweep.load_runs(os.path.join(
                args.out_dir, f"{model_type}_seed_sweep{args.tag}.csv"),
                "seed"), baseline, png, model_type)
        else:
            png = f"{stem}_learning_curve.png"
            with open(f"{stem}_progress.csv", newline="") as f:
                rows = [{k: float(v) for k, v in r.items() if v}
                        for r in csv.DictReader(f)]
            learning_curve.plot_curves(rows, baseline, png, model_type)
        pngs.append(png)
    return pngs


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--types", nargs="+", required=True,
                   help="model types, one run each, started in this order")
    p.add_argument("--runner", choices=sorted(RUNNERS),
                   default="learning_curve")
    p.add_argument("--per-card", type=int, default=1,
                   help="runs at once on one card")
    p.add_argument("--tag", default="", help="the runners' --tag")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--results-root",
                   help="root of the runs' directories (needed to train)")
    p.add_argument("--device", default="cuda",
                   help="the cards (default; raises without one) or 'cpu'")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--deadline-s", type=float, default=None)
    p.add_argument("--plot-only", action="store_true")
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="-- then arguments for every runner")
    return p


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    args.rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    if args.plot_only:
        pngs = plot(args)
        print(json.dumps({"plots": pngs}), flush=True)
        return {"plots": pngs}
    if args.results_root is None:
        parser().error("--results-root is needed to train")
    from placement_tpu_torch.env import core
    core.check_device(args.device, "learning_runs")
    if args.device == "cuda":
        import torch
        cards = torch.cuda.device_count()
    else:
        cards = 1
    os.makedirs(args.out_dir, exist_ok=True)
    at_once = min(len(args.types), args.per_card * cards)
    threads = max(1, len(os.sched_getaffinity(0)) // at_once)
    queue = [t for t in args.types if not (args.resume and os.path.exists(
        os.path.join(args.out_dir, f"{t}{args.tag}_summary.json")))]
    running, done = {}, []
    t_start = time.perf_counter()

    def start(model_type, card):
        stem = os.path.join(args.out_dir, f"{model_type}{args.tag}")
        root = os.path.join(args.results_root, f"{model_type}{args.tag}")
        env = dict(os.environ, OMP_NUM_THREADS=str(threads))
        if args.device == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = str(card)
        log = open(f"{stem}.log", "a")
        proc = subprocess.Popen(_runner_args(args, model_type, root),
                                stdout=log, stderr=subprocess.STDOUT,
                                env=env)
        running[proc] = (model_type, card, log, time.perf_counter(), stem,
                         root)
        print(f"started {model_type} on card {card} (pid {proc.pid})",
              flush=True)

    def finish(proc, cut):
        from placement_tpu_torch.agent.trainer import latest_run_dir
        model_type, card, log, t0, stem, root = running.pop(proc)
        log.close()
        try:
            run_dir = latest_run_dir(model_type, root)
        except FileNotFoundError:
            run_dir = None
        summary = _last_json(f"{stem}.log") if not cut else None
        record = {
            "type": model_type, "card_index": card,
            "card": _card(args.device, card),
            "runs_per_card": args.per_card, "cards": cards,
            "runs_at_once": at_once, "intra_op_threads": threads,
            "rc": proc.returncode, "cut": cut,
            "wall_s": time.perf_counter() - t0,
            "s_per_iteration": (seconds_per_iteration(run_dir)
                                if run_dir else None),
            "run_dir": run_dir,
        }
        if proc.returncode == 0 and summary is not None:
            with open(f"{stem}_summary.json", "w") as f:
                json.dump({**summary, **record}, f, indent=1)
        done.append(record)
        print(f"ended {model_type}: {record!r}", flush=True)

    try:
        while queue or running:
            for proc in list(running):
                if proc.poll() is not None:
                    finish(proc, cut=False)
            for card in range(cards):
                while queue and sum(c == card for _, c, *_ in
                                    running.values()) < args.per_card:
                    start(queue.pop(0), card)
            if (args.deadline_s is not None
                    and time.perf_counter() - t_start > args.deadline_s):
                for proc in running:
                    proc.terminate()
                for proc in list(running):
                    try:
                        proc.wait(timeout=60)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
                    finish(proc, cut=True)
                break
            time.sleep(1.0)
    finally:
        for proc in list(running):
            proc.kill()
            proc.wait()
            finish(proc, cut=True)
    out = {"runs": done, "wall_s": time.perf_counter() - t_start}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
