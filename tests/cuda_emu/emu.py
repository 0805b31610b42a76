"""Build the port's CUDA sources with g++ and run their kernels on the CPU.

A test aid for machines without ``nvcc`` or a GPU: ``cuda_runtime.h`` beside
this file stands in for the CUDA runtime (a warp's lanes are fibers, every
warp intrinsic a meeting of the lanes in its mask), and each
``kernel<<<grid, threads, 0, stream>>>(`` becomes ``emu_launch(kernel, grid,
threads, ``. The library keeps the kernels' C interface, so
``fused_rollout_launch`` runs on host pointers.

    build(csrc_dir, out_dir)          -> path of the emulated library
    run_chunks(lib, params, leaves, seeds, steps, block, timeout)
                                      -> per chunk (leaves, rsum, dcnt)

``run_chunks`` runs in a child process (this file as a script), so a kernel
that crashes, deadlocks or runs away fails one test within its time limit
and not the whole test run. The package never loads an emulated library: the
card's kernels come from ``placement_tpu_torch/ops/_build.py`` alone.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
GXX_FLAGS = ("-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
             "-w")
#: ``name<...><<<grid, threads, 0, stream>>>(`` of a kernel launch
_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)\s*<<<\s*([^,>]+),\s*([^,>]+),"
                     r"[^>]*>>>\s*\(")

#: the order of the leaf pointers in the kernels' FusedRolloutLeaves
LEAVES = ("grid", "comp_h", "comp_w", "cursor", "num_components",
          "pin_rel_x", "pin_rel_y", "pin_abs_x", "pin_abs_y",
          "pin_net", "pin_comp", "num_pins", "plane0", "plane1")


def compiler() -> "str | None":
    return shutil.which("g++")


def build(csrc: pathlib.Path, out_dir: pathlib.Path,
          name: str = "libemulated_kernels.so") -> pathlib.Path:
    """Copy ``csrc``'s sources to ``out_dir`` with every launch rewritten,
    and compile them into one shared library against the stand-in runtime."""
    out_dir.mkdir(parents=True, exist_ok=True)
    units = []
    for src in sorted(csrc.iterdir()):
        if src.suffix not in (".cu", ".cuh"):
            continue
        text = _LAUNCH.sub(r"emu_launch(\1, \2, \3, ", src.read_text())
        dst = out_dir / (src.stem + ".cpp" if src.suffix == ".cu"
                         else src.name)
        dst.write_text(text)
        if "<<<" in text:
            raise RuntimeError(f"{src}: a kernel launch was not rewritten")
        if src.suffix == ".cu":
            units.append(str(dst))
    lib = out_dir / name
    cmd = [compiler(), *GXX_FLAGS, f"-I{HERE}", f"-I{out_dir}", "-o",
           str(lib), *units]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    return lib


def run_chunks(lib: pathlib.Path, params: ctypes.Structure,
               leaves: "dict[str, np.ndarray]", seeds: "list[int]",
               steps: int, block: int, timeout: float):
    """Chained chunks of ``fused_rollout_launch`` from ``leaves`` (numpy,
    ``[batch, width]``), one per seed, in a child process held to
    ``timeout`` seconds. Returns a list of ``(leaves, rsum, dcnt)``."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        np.savez(tmp / "in.npz", _params=np.frombuffer(bytes(params),
                                                       dtype=np.uint8),
                 _seeds=np.asarray(seeds, np.int64),
                 _steps_block=np.asarray([steps, block], np.int64),
                 **{k: leaves[k] for k in LEAVES})
        proc = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()), str(lib),
             str(tmp / "in.npz"), str(tmp / "out.npz")],
            capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"emulated kernel failed ({proc.returncode}):"
                               f"\n{proc.stdout}\n{proc.stderr}")
        got = np.load(tmp / "out.npz")
        return [({k: got[f"{i}_{k}"] for k in LEAVES}, got[f"{i}_rsum"],
                 got[f"{i}_dcnt"]) for i in range(len(seeds))]


def _main(lib_path: str, in_path: str, out_path: str) -> None:
    lib = ctypes.CDLL(lib_path)
    lib.fused_rollout_launch.restype = ctypes.c_int
    lib.fused_rollout_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 3 + [ctypes.c_uint32, ctypes.c_void_p]
    data = np.load(in_path)
    params = np.ascontiguousarray(data["_params"])
    steps, block = (int(v) for v in data["_steps_block"])
    leaves = {k: np.ascontiguousarray(data[k]) for k in LEAVES}
    batch = leaves["grid"].shape[0]
    out = {}
    for i, seed in enumerate(data["_seeds"]):
        new = {k: np.empty_like(v) for k, v in leaves.items()}
        rsum = np.empty(batch, np.float32)
        dcnt = np.empty(batch, np.int32)
        ins = (ctypes.c_void_p * len(LEAVES))(
            *[leaves[k].ctypes.data for k in LEAVES])
        outs = (ctypes.c_void_p * len(LEAVES))(
            *[new[k].ctypes.data for k in LEAVES])
        err = lib.fused_rollout_launch(
            params.ctypes.data, ctypes.addressof(ins),
            ctypes.addressof(outs), rsum.ctypes.data, dcnt.ctypes.data,
            batch, steps, block, int(seed) & 0xFFFFFFFF, None)
        if err != 0:
            raise SystemExit(f"fused_rollout_launch returned {err}")
        out.update({f"{i}_{k}": v for k, v in new.items()})
        out[f"{i}_rsum"], out[f"{i}_dcnt"] = rsum, dcnt
        leaves = new
    np.savez(out_path, **out)


if __name__ == "__main__":
    _main(*sys.argv[1:4])
