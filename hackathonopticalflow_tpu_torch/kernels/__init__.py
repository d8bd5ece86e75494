"""Build and load the port's CUDA kernels.

Each csrc/<name>.cu has a plain C interface. At first use it is compiled
by nvcc for sm_90a into build/torch_kernels/ at the repository root (a
git-ignored directory), under a name carrying the source's hash, and
loaded with ctypes. Nothing is compiled at import time: a machine
without a CUDA toolkit imports this module and never calls it."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    # no FMA contraction: kernels reproduce their plain versions' f32
    # rounding bit for bit (csrc/lk_level.cu, csrc/warp_bilinear.cu)
    "-fmad=false",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where the shared library for csrc/<name>.cu is (or will be) built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless an up-to-date build exists. nvcc's
    output (ptxas register and shared-memory report) is kept beside the
    library as <lib>.log."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all(names: list[str]) -> list[Path]:
    """build() each of csrc/<name>.cu, one nvcc per source, all started
    together."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        return list(ex.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
