"""Building the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C entry point. It is compiled at
first use with ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_kernels/`` at the repository root, named by a hash of the
source, the headers of ``csrc/`` and the flags (so an edit rebuilds), and
loaded with ``ctypes``. Nothing here runs when a module is imported: the
machines without ``nvcc`` import every module too. Each build and each
load is a compile for ``utils/jitwatch.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..utils import jitwatch
from . import weights

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

#: bit h set when hashgroup h is body-ish (weights.IN_BODY)
IN_BODY_MASK = sum(1 << h for h, b in enumerate(weights.IN_BODY) if b)

_libs: dict = {}
_table_cache: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` into a shared library unless one built
    from the same sources and flags exists. Returns its path and the
    compiler's report (``-Xptxas=-v``: registers, shared memory, spills),
    kept beside the library for later calls."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    report = so.with_name(f"{so.name}.ptxas.txt")
    if so.exists():
        return so, report.read_text() if report.exists() else ""
    jitwatch.note_compile(name, "nvcc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):"
                           f"\n{proc.stderr}{proc.stdout}")
    report.write_text(proc.stderr + proc.stdout)
    os.replace(tmp, so)
    return so, proc.stderr + proc.stdout


def load(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, built at first
    use; it returns a CUDA error code (0 = launched)."""
    key = (name, symbol)
    fn = _libs.get(key)
    if fn is None:
        path = build(name)[0]
        jitwatch.note_compile(name, "load")
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _libs[key] = fn
    return fn


def kernel_tables(device: torch.device) -> torch.Tensor:
    """The kernels' weight tables on ``device``: the 16 hashgroup weights,
    then the 32 density weights (float32)."""
    t = _table_cache.get(device)
    if t is None:
        t = torch.from_numpy(np.concatenate(
            [weights.HASH_GROUP_WEIGHTS, weights.DENSITY_WEIGHTS])).to(device)
        _table_cache[device] = t
    return t


def check_inputs(device: torch.device, specs) -> None:
    """Raise unless every ``(name, tensor, dtype, shape)`` is a contiguous
    tensor of that type and shape on ``device``."""
    for name, t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous on {device}")
