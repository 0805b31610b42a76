"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``ops/csrc/*.cu`` file is compiled into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The
library lands in ``build/torch_kernels/`` at the root of the checkout, named
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. Nothing here imports a CUDA-only module, so the
CPU tests can import it; a build happens only when a caller asks for the
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Tuple

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

#: IEEE division and sqrt are nvcc's defaults; ``-fmad=false`` keeps FMA
#: contraction from changing the rounding of the routing reward, so the
#: kernel rounds exactly as the plain PyTorch version does.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")


def sources() -> "list[pathlib.Path]":
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libplacement_kernels_{source_hash()}.so"


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


def build() -> Tuple[pathlib.Path, float]:
    """Compile the sources unless this hash is built; returns the library
    path and the seconds spent compiling (0.0 when reused). The compiler's
    output (``-Xptxas=-v``: registers, spills) is kept beside the library
    as ``<name>.log``."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib, seconds


def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernel library."""
    return ctypes.CDLL(str(build()[0]))
