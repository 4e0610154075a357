"""Public wrappers for the port's hand-written kernels, and their build.

A wrapper takes the plain PyTorch version (``kernels/ref.py``) only for
tensors on the CPU. For CUDA tensors it launches the kernel or raises;
nothing falls back. A ``FakeTensor`` input, on any device, takes the
kernel's fake route (``kernels/counting.py``): fake outputs of the
kernel's shapes, its dot FLOPs reported to the counter, no build and no
launch (a dry-run's trace, ``launch/dryrun.py``). Each wrapper counts its
kernel launches in
:data:`LAUNCHES`, a plain integer per kernel, so a run can show that its
main path went through the kernel (a call under CUDA graph capture counts
in :data:`CAPTURED` instead, and each replay of the graph adds it).

``flash_attention``, ``ssd_chunk`` and ``selective_scan`` are
differentiable: under grad each is a ``torch.autograd.Function`` whose
forward kernel also writes what its backward reads (the attention's
log-sum-exp, the scans' f32 state entering each 64-step chunk or tile)
and whose backward is a kernel of its own (``flash_attention_bwd``,
``ssd_chunk_bwd``, ``selective_scan_bwd``). On the CPU the forward and the
backward are the plain versions; on CUDA a failed build or launch raises,
and nothing falls back to them.

The CUDA sources under ``csrc/`` are compiled at first use with ``nvcc``
into ``build/`` at the repository root, one shared library per source
with a plain C interface, loaded with ``ctypes``. Each library has its own
flags (``NVCC_FLAGS`` plus its entry in ``EXTRA_FLAGS``); the library name
carries a hash of the source, of the ``csrc/`` headers it includes
(``hopper.cuh``, shared by both attention libraries) and of those flags, so
an edited source or header or a changed flag is rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import counting
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as _ss
from repro_torch.kernels import ssd_chunk as _sc
from repro_torch.kernels import topk_select as _tk

CSRC = Path(__file__).resolve().parent / "csrc"
# -Xptxas -v: ptxas reports each kernel's registers and spills, kept
# beside the library (:func:`ptxas_log`)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# topk_select reproduces the reference's one fused multiply-add bit for bit
# and must not let nvcc contract anything else; the other kernels only have
# to agree within a tolerance and keep FMA contraction
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {
    "topk_select": ("-fmad=false",), "flash_attention": (),
    "flash_attention_bwd": (), "ssd_chunk": (), "ssd_chunk_bwd": (),
    "selective_scan": (), "selective_scan_bwd": ()}

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

LAUNCHES: Dict[str, int] = {"topk_reward": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0, "ssd_chunk": 0,
                            "ssd_chunk_bwd": 0, "selective_scan": 0,
                            "selective_scan_bwd": 0}
# wrapper calls made while a CUDA graph was being captured: they launch
# nothing then. ``federated/replay.py`` adds a graph's captured calls to
# LAUNCHES at each replay, where the kernel really runs.
CAPTURED: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)
_BINDERS = {"topk_select": _tk.bind,   # declares each library's C signatures
            "flash_attention": _fa.bind,
            "flash_attention_bwd": _fa.bind_bwd, "ssd_chunk": _sc.bind,
            "ssd_chunk_bwd": _sc.bind_bwd, "selective_scan": _ss.bind,
            "selective_scan_bwd": _ss.bind_bwd}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put it on PATH")
    return found


def nvcc_flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS[name]


def sources(name: str) -> Tuple[Path, ...]:
    """``csrc/<name>.cu`` and, in the order first met, every header it
    includes with ``#include "..."``, directly or through another one."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / inc for inc in re.findall(
            r'^\s*#\s*include\s*"([^"]+)"', path.read_text(), re.M)]
    return tuple(found)


def library_path(name: str) -> Path:
    """``build/lib<name>-<hash>.so``, the hash over the source, the headers
    it includes (:func:`sources`) and the library's own flags."""
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources(name))
                            + " ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def ptxas_log(name: str) -> Path:
    """What the build of library ``name`` printed (ptxas's report of each
    kernel's registers and spills), beside :func:`library_path`."""
    out = library_path(name)
    return out.with_name(f"{out.name}.log")


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into :func:`library_path` unless that file
    exists already, and keep nvcc's report in :func:`ptxas_log`; returns
    the library's path. Raises on a failed build. Safe to call for several
    libraries at once from threads (each runs its own ``nvcc`` and renames
    its outputs into place)."""
    out = library_path(name)
    if out.exists():
        return out
    src = CSRC / f"{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *nvcc_flags(name), "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    log = ptxas_log(name)
    log_tmp = log.with_name(f"{log.name}.{os.getpid()}.tmp")
    log_tmp.write_text(proc.stderr)
    os.replace(log_tmp, log)
    os.replace(tmp, out)
    return out


def load_library(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        _LIBS[name] = _BINDERS[name](ctypes.CDLL(str(build_library(name))))
    return _LIBS[name]


def _count(name: str) -> None:
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] += 1
    else:
        LAUNCHES[name] += 1


def topk_reward(a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor, *,
                f: float, k: int, block_n: int = _tk.DEFAULT_BLOCK_N,
                ucb=None, mode: str = "eafl", index_offset: int = 0):
    """Fused selection score + exact top-k: ``(values (k,), idx (k,))``.

    ``a``/``b``: (N,) float32 score inputs (normalised by the caller for
    ``eafl``); ``valid``: (N,) mask, bool or uint8 as the kernel reads it
    (any other dtype is compared with 0 first); ``ucb``: optional (N,)
    float32 bonus. Values are descending in ``lax.top_k``'s total order
    (+0 above -0, +NaN first, -NaN last) with ties lowest index first;
    masked clients score ``SENTINEL``. ``k`` must lie in ``[1, min(block_n,
    N)]`` on both devices (beyond it the reference kernel re-emits index
    0).
    CPU tensors take the plain version; CUDA tensors the Hopper kernel;
    fake tensors the fake route."""
    bn = min(int(block_n), int(a.shape[0]))
    if not 1 <= k <= bn:
        raise ValueError(f"k={k} must lie in [1, min(block_n, N)={bn}]")
    if counting.is_fake(a):
        return _tk.fake(a, k=k)
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
    _count("topk_reward")
    return out


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _FlashAttention(torch.autograd.Function):
    """Attention with its backward: the forward kernel writes each row's
    log-sum-exp, saved with q, k, v and o; the backward runs
    :func:`flash_attention_bwd`. On the CPU both are the plain versions."""

    @staticmethod
    def forward(q, k, v, causal):
        if counting.is_fake(q):
            return _fa.fake(q, k, v, causal=causal, with_lse=True)
        if q.device.type == "cpu":
            return ref.flash_attention_fwd_lse(q, k, v, causal=causal)
        out = _fa.launch(load_library("flash_attention"), q, k, v,
                         causal=causal, with_lse=True)
        _count("flash_attention")
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal = inputs
        o, lse = output
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention forward in the model's layout: q ``(B, S, H,
    Dqk)``, k ``(B, S, KH, Dqk)`` and v ``(B, S, KH, Dv)`` with ``H % KH ==
    0``; returns ``(B, S, H, Dv)`` in q's dtype. Scale ``Dqk**-0.5``,
    causal mask ``-1e30``. CPU tensors take the plain version; CUDA
    tensors the Hopper kernel (f32 softmax and accumulation), which takes
    the ``(Dqk, Dv)`` pairs of ``flash_attention.HEAD_DIMS`` and raises on
    any other: nothing falls back. Under grad, with an input that requires it, it is
    differentiable (:class:`_FlashAttention`, dv at v's width): the kernel
    then also writes the log-sum-exp the backward reads."""
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal)[0]
    if counting.is_fake(q):
        return _fa.fake(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal)
    out = _fa.launch(load_library("flash_attention"), q, k, v, causal=causal)
    _count("flash_attention")
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True):
    """The gradient of :func:`flash_attention`: ``(dq, dk, dv)`` in the
    inputs' dtypes, from the forward's inputs, its output ``o``, its f32
    log-sum-exp ``lse`` ``(B, H, S)`` and the output's gradient ``do``.
    CPU tensors take the plain version; CUDA tensors the Hopper kernel,
    built for the ``(Dqk, Dv)`` pairs of ``flash_attention.BWD_HEAD_DIMS``,
    the forward's (a ``do`` whose layout the kernel does not take is made
    contiguous first)."""
    if counting.is_fake(q):
        return _fa.fake_bwd(q, k, v, o, lse, do, causal=causal)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    if not _fa.kernel_ready(do):
        do = do.contiguous()
    out = _fa.launch_bwd(load_library("flash_attention_bwd"), q, k, v, o,
                         lse, do, causal=causal)
    _count("flash_attention_bwd")
    return out


class _SSDChunk(torch.autograd.Function):
    """The SSD scan with its backward: the forward kernel writes the f32
    state entering each 64-step chunk, saved with the inputs; the backward
    runs :func:`ssd_chunk_bwd`. On the CPU both are the plain versions."""

    @staticmethod
    def forward(x, Bm, Cm, dt, A):
        if counting.is_fake(x):
            return _sc.fake(x, Bm, Cm, dt, A, with_states=True)
        if x.device.type == "cpu":
            return ref.ssd_chunk(x, Bm, Cm, dt, A), x.new_empty(0)
        out = _sc.launch(load_library("ssd_chunk"), x, Bm, Cm, dt, A,
                         with_states=True)
        _count("ssd_chunk")
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(*inputs, output[1])

    @staticmethod
    def backward(ctx, dy, _dstates):
        x, Bm, Cm, dt, A, states = ctx.saved_tensors
        dx, dB, dC, ddt, dA = ssd_chunk_bwd(x, Bm, Cm, dt, A, dy, states)
        return dx, dB, dC, ddt.to(dt.dtype), dA.to(A.dtype)


def ssd_chunk(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
              dt: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Mamba2 SSD scan: x ``(B, S, nh, hd)``, Bm/Cm ``(B, S, ds)``, dt
    ``(B, S, nh)`` (after softplus), A ``(nh,)`` negative; returns y
    ``(B, S, nh, hd)`` in x's dtype, with no D skip. CPU tensors take the
    plain (sequential) version; CUDA tensors the Hopper kernel. Under
    grad, with an input that requires it, it is differentiable
    (:class:`_SSDChunk`): the kernel then also writes the chunk states
    the backward kernel reads."""
    if _needs_grad(x, Bm, Cm, dt, A):
        return _SSDChunk.apply(x, Bm, Cm, dt, A)[0]
    if counting.is_fake(x):
        return _sc.fake(x, Bm, Cm, dt, A)
    if x.device.type == "cpu":
        return ref.ssd_chunk(x, Bm, Cm, dt, A)
    out = _sc.launch(load_library("ssd_chunk"), x, Bm, Cm, dt, A)
    _count("ssd_chunk")
    return out


def ssd_chunk_bwd(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                  dt: torch.Tensor, A: torch.Tensor, dy: torch.Tensor,
                  states=None):
    """The gradient of :func:`ssd_chunk`: ``(dx, dBm, dCm, ddt, dA)``, dx,
    dBm and dCm in their inputs' dtypes, ddt and dA in f32, from the
    forward's inputs, the output's gradient ``dy`` and (on CUDA) the
    forward kernel's chunk states (``kernels/ssd_chunk.py::launch(...,
    with_states=True)``). CPU tensors take the plain version (which
    recomputes the states); CUDA tensors the Hopper kernel (a ``dy`` whose
    last dimension is strided is made contiguous first)."""
    if counting.is_fake(x):
        return _sc.fake_bwd(x, Bm, Cm, dt, A, dy)
    if x.device.type == "cpu":
        return ref.ssd_chunk_bwd(x, Bm, Cm, dt, A, dy)
    if states is None:
        raise ValueError("ssd_chunk_bwd on CUDA needs the forward's states")
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    out = _sc.launch_bwd(load_library("ssd_chunk_bwd"), x, Bm, Cm, dt, A,
                         dy, states)
    _count("ssd_chunk_bwd")
    return out


class _SelectiveScan(torch.autograd.Function):
    """The Mamba1 scan with its backward: the forward kernel writes the
    f32 state entering each 64-step tile, saved with the inputs; the
    backward runs :func:`selective_scan_bwd`. On the CPU both are the
    plain versions."""

    @staticmethod
    def forward(x, dt, Bm, Cm, A, D):
        if counting.is_fake(x):
            return _ss.fake(x, dt, Bm, Cm, A, D, with_states=True)
        if x.device.type == "cpu":
            return ref.selective_scan(x, dt, Bm, Cm, A, D), x.new_empty(0)
        out = _ss.launch(load_library("selective_scan"), x, dt, Bm, Cm, A, D,
                         with_states=True)
        _count("selective_scan")
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(*inputs, output[1])

    @staticmethod
    def backward(ctx, dy, _dstates):
        x, dt, Bm, Cm, A, D, states = ctx.saved_tensors
        dx, ddt, dB, dC, dA, dD = selective_scan_bwd(x, dt, Bm, Cm, A, D, dy,
                                                     states)
        return dx, ddt, dB, dC, dA.to(A.dtype), dD.to(D.dtype)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor,
                   D: torch.Tensor) -> torch.Tensor:
    """Mamba1 selective scan: x, dt ``(B, S, di)`` (dt after softplus), Bm/Cm
    ``(B, S, ds)``, A ``(di, ds)`` negative, D ``(di,)``; returns y
    ``(B, S, di)`` in x's dtype, with the D skip. CPU tensors take the plain
    (sequential) version; CUDA tensors the Hopper kernel. Under grad, with
    an input that requires it, it is differentiable
    (:class:`_SelectiveScan`): the kernel then also writes the tile states
    the backward kernel reads."""
    if _needs_grad(x, dt, Bm, Cm, A, D):
        return _SelectiveScan.apply(x, dt, Bm, Cm, A, D)[0]
    if counting.is_fake(x):
        return _ss.fake(x, dt, Bm, Cm, A, D)
    if x.device.type == "cpu":
        return ref.selective_scan(x, dt, Bm, Cm, A, D)
    out = _ss.launch(load_library("selective_scan"), x, dt, Bm, Cm, A, D)
    _count("selective_scan")
    return out


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                       Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                       dy: torch.Tensor, states=None):
    """The gradient of :func:`selective_scan`: ``(dx, ddt, dBm, dCm, dA,
    dD)``, dx, ddt, dBm and dCm in their inputs' dtypes, dA and dD in f32,
    from the forward's inputs, the output's gradient ``dy`` and (on CUDA)
    the forward kernel's tile states (``kernels/selective_scan.py::launch(
    ..., with_states=True)``). CPU tensors take the plain version (which
    recomputes the states); CUDA tensors the Hopper kernel (a ``dy`` whose
    last dimension is strided is made contiguous first)."""
    if counting.is_fake(x):
        return _ss.fake_bwd(x, dt, Bm, Cm, A, D, dy)
    if x.device.type == "cpu":
        return ref.selective_scan_bwd(x, dt, Bm, Cm, A, D, dy)
    if states is None:
        raise ValueError("selective_scan_bwd on CUDA needs the forward's "
                         "states")
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    out = _ss.launch_bwd(load_library("selective_scan_bwd"), x, dt, Bm, Cm,
                         A, D, dy, states)
    _count("selective_scan_bwd")
    return out
