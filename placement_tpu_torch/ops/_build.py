"""Build the port's CUDA kernels with ``nvcc`` (``fused_rollout`` loads them
with ``ctypes``).

Every ``ops/csrc/*.cu`` file is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). The
library lands in ``build/torch_kernels/`` at the root of the checkout, named
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. Nothing here imports a CUDA-only module, so the
CPU tests can import it; a build happens only when a caller asks for the
library.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Tuple

from placement_tpu_torch.utils import profiling

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

#: IEEE division and sqrt are nvcc's defaults; ``-fmad=false`` keeps FMA
#: contraction from changing the rounding of the routing reward, so the
#: kernel rounds exactly as the plain PyTorch version does.
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xptxas=-v",
              "-Xcompiler", "-fPIC")


def sources(csrc: "pathlib.Path | None" = None) -> "list[pathlib.Path]":
    csrc = csrc or CSRC
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def source_hash(csrc: "pathlib.Path | None" = None) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(csrc):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(csrc: "pathlib.Path | None" = None,
                 build_dir: "pathlib.Path | None" = None) -> pathlib.Path:
    return ((build_dir or BUILD_DIR)
            / f"libplacement_kernels_{source_hash(csrc)}.so")


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def build(csrc: "pathlib.Path | None" = None,
          build_dir: "pathlib.Path | None" = None
          ) -> Tuple[pathlib.Path, float]:
    """Compile the sources (``csrc``, by default the package's) unless this
    hash is built; returns the library path and the seconds spent compiling
    (0.0 when reused). The compilers' output (``-Xptxas=-v``: registers,
    spills, stack frames) is kept beside the library as ``<name>.log``. A
    compile is the span ``fused_rollout.build``."""
    csrc = csrc or CSRC
    lib = library_path(csrc, build_dir)
    if lib.exists():
        return lib, 0.0
    with profiling.span("fused_rollout.build"):
        return _compile(csrc, lib)


def _compile(csrc: pathlib.Path, lib: pathlib.Path
             ) -> Tuple[pathlib.Path, float]:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(csrc.glob("*.cu")):
        obj = tmp.with_suffix(f".{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = [nvcc, *ARCH, "-shared", "-o", str(tmp),
                *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
    finally:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    lib.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, lib)
    return lib, seconds
