"""Public wrappers for the port's hand-written kernels, and their build.

A wrapper takes the plain PyTorch version (``kernels/ref.py``) only for
tensors on the CPU. For CUDA tensors it launches the kernel or raises;
nothing falls back. Each wrapper counts its kernel launches in
:data:`LAUNCHES`, a plain integer per kernel, so a run can show that its
main path went through the kernel.

The CUDA sources under ``csrc/`` are compiled at first use with ``nvcc``
into ``build/`` at the repository root, one shared library per source
with a plain C interface, loaded with ``ctypes``. The library name carries
a hash of the source and the flags, so an edited source is rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import topk_select as _tk

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

LAUNCHES: Dict[str, int] = {"topk_reward": 0}
_BINDERS = {"topk_select": _tk.bind}   # declares each library's C signatures
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put it on PATH")
    return found


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``build/lib<name>-<hash>.so`` unless
    that file exists already; returns its path. Raises on a failed build."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        _LIBS[name] = _BINDERS[name](ctypes.CDLL(str(build_library(name))))
    return _LIBS[name]


def topk_reward(a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor, *,
                f: float, k: int, block_n: int = _tk.DEFAULT_BLOCK_N,
                ucb=None, mode: str = "eafl", index_offset: int = 0):
    """Fused selection score + exact top-k: ``(values (k,), idx (k,))``.

    ``a``/``b``: (N,) float32 score inputs (normalised by the caller for
    ``eafl``); ``valid``: (N,) mask, bool or uint8 as the kernel reads it
    (any other dtype is compared with 0 first); ``ucb``: optional (N,)
    float32 bonus. Values are descending with ties lowest index first; masked
    clients score ``SENTINEL``. ``k`` must lie in ``[1, min(block_n, N)]``
    on both devices (beyond it the reference kernel re-emits index 0).
    CPU tensors take the plain version; CUDA tensors the Hopper kernel."""
    bn = min(int(block_n), int(a.shape[0]))
    if not 1 <= k <= bn:
        raise ValueError(f"k={k} must lie in [1, min(block_n, N)={bn}]")
    if a.device.type == "cpu":
        return ref.topk_reward(a, b, valid, f=f, k=k, ucb=ucb, mode=mode,
                               index_offset=index_offset)
    if valid.dtype not in _tk.MASK_DTYPES:
        valid = valid != 0
    lib = load_library("topk_select")
    out = _tk.launch(lib, a.contiguous(), b.contiguous(),
                     valid.contiguous(), f=f, k=k,
                     block_n=block_n,
                     ucb=None if ucb is None else ucb.contiguous(),
                     mode=mode, index_offset=index_offset)
    LAUNCHES["topk_reward"] += 1
    return out
