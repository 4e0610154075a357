"""EAFL reward + exact top-k client selection: the Hopper kernel's launcher.

Replaces the Pallas TPU kernel ``repro/kernels/topk_select.py``
(``_topk_kernel`` / ``topk_reward``). The kernel is CUDA C++ in
``csrc/topk_select.cu`` (its header comment holds the design and the bound:
13 bytes read per client, about 4.1 us at 1,048,576 clients on an H100 SXM
at 3.35 TB/s), compiled by :func:`repro_torch.kernels.ops.build_library`
and called here through its plain C interface with ``ctypes``.

What it computes is the reference's function, not its blocks carried over:
a global stable top-k of ``where(valid, mix(a, b) * (1 + ucb), SENTINEL)``
(values descending, ties lowest index first). The reference's final
``lax.top_k`` over block candidates has exactly that order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import MODES, SENTINEL

DEFAULT_BLOCK_N = 4096
MAX_BLOCK_N = 8192        # pass 1 holds 8 bytes of shared memory per client
MASK_DTYPES = (torch.bool, torch.uint8)   # the kernel reads one byte a client

_READY = set()            # devices whose shared-memory limits are raised

__all__ = ["DEFAULT_BLOCK_N", "MAX_BLOCK_N", "MODES", "SENTINEL", "launch",
           "bind"]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures (pointers and the stream as ``c_void_p``,
    so ctypes never truncates them to 32 bits)."""
    p, i32, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
    lib.topk_reward_init.argtypes = [i32]
    lib.topk_reward_init.restype = i32
    lib.topk_reward_scratch_len.argtypes = [i64, i32, i32]
    lib.topk_reward_scratch_len.restype = i64
    lib.topk_reward_launch.argtypes = [p, p, p, p, i64, i32, f, f, i32, i32,
                                       i32, p, p, p, p, p]
    lib.topk_reward_launch.restype = i32
    return lib


def _check(name: str, t: torch.Tensor, n: int, dtypes, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.shape != (n,):
        raise ValueError(f"{name} must have shape ({n},), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(lib: ctypes.CDLL, a: torch.Tensor, b: torch.Tensor,
           valid: torch.Tensor, *, f: float, k: int,
           block_n: int = DEFAULT_BLOCK_N, ucb=None, mode: str = "eafl",
           index_offset: int = 0):
    """Launch the kernel on PyTorch's current stream (no synchronise).

    ``a``/``b``/``ucb``: (N,) float32 CUDA tensors; ``valid``: (N,) bool
    or uint8.
    Returns ``(values (k,) f32, indices (k,) int32)``. Raises on anything
    the kernel does not take and on a launch error."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    n = int(a.shape[0])
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"the topk_reward kernel runs on CUDA, got {dev}")
    block_n = min(int(block_n), n)
    if not 1 <= k <= block_n:
        raise ValueError(f"k={k} must lie in [1, min(block_n, N)={block_n}]")
    if block_n > MAX_BLOCK_N:
        raise ValueError(f"block_n={block_n} exceeds {MAX_BLOCK_N}")
    _check("a", a, n, (torch.float32,), dev)
    _check("b", b, n, (torch.float32,), dev)
    _check("valid", valid, n, MASK_DTYPES, dev)
    if ucb is not None:
        _check("ucb", ucb, n, (torch.float32,), dev)
    if dev.index not in _READY:
        with torch.cuda.device(dev):
            err = lib.topk_reward_init(MAX_BLOCK_N)
        if err != 0:
            raise RuntimeError(f"topk_reward kernel set-up failed: CUDA "
                               f"error {err}")
        _READY.add(dev.index)
    # one allocation holds both scratch halves and the outputs; the scratch
    # may be freed as soon as this returns: PyTorch's caching allocator
    # hands it only to work queued after the kernel on this stream
    half = lib.topk_reward_scratch_len(n, k, block_n)
    buf = torch.empty(4 * half + 2 * k, dtype=torch.int32, device=dev)
    scratch_i = buf[:2 * half]
    scratch_v = buf[2 * half:4 * half].view(torch.float32)
    out_i = buf[4 * half:4 * half + k]
    out_v = buf[4 * half + k:].view(torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.topk_reward_launch(
        a.data_ptr(), b.data_ptr(), None if ucb is None else ucb.data_ptr(),
        valid.data_ptr(), n, MODES.index(mode), float(f), 1.0 - float(f),
        k, block_n, int(index_offset), scratch_v.data_ptr(),
        scratch_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"topk_reward kernel launch failed: CUDA error {err}")
    return out_v, out_i
