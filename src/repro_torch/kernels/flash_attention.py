"""Softmax attention forward: the Hopper kernel's launcher.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_kernel`` / ``flash_attention``). The kernel is CUDA C++ in
``csrc/flash_attention.cu`` (its header holds the design and the bound:
137 GFLOP at B*H=64, S=4096, hd=64 causal, about 0.14 ms of bf16
tensor-core work on an H100 SXM), compiled by
:func:`repro_torch.kernels.ops.build_library` and called here through its
plain C interface with ``ctypes``.

It takes the model's layout: q ``(B, S, H, hd)``, k and v ``(B, S, KH, hd)``
with ``H % KH == 0``, read through their strides (last dimension
contiguous; bf16 rows 16-byte aligned, as every fresh or packed
projection's are: the bf16 kernel copies tiles by TMA through tensor maps
that its launch function builds from these strides), and returns a
contiguous ``(B, S, H, hd)`` tensor in q's dtype. The reference's wrapper
takes ``(B, H, S, D)``; the math is the same: scale ``hd**-0.5``, causal
mask ``-1e30``, f32 accumulation, denominator clamped at ``1e-30``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import stream_handle
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)     # the head sizes the library is built for
MAX_GRID_Y = 65535        # one CTA row per (batch, head)

__all__ = ["DTYPES", "HEAD_DIMS", "bind", "check_inputs", "launch"]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature (pointers and the stream as ``c_void_p``)."""
    p, i32, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
    lib.flash_attention_launch.argtypes = (
        [p, p, p, p] + [i32] * 7 + [f] + [i64] * 9 + [p])
    lib.flash_attention_launch.restype = i32
    return lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Raise on what the kernel does not take (on any device)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be 4-d: (B, S, H, hd), (B, S, KH, hd)")
    B, S, H, D = q.shape
    KH = k.shape[2]
    if k.shape != (B, S, KH, D) or v.shape != k.shape:
        raise ValueError(f"k, v must have shape {(B, S, KH, D)}, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if KH == 0 or H % KH:
        raise ValueError(f"H={H} must be a multiple of KH={KH}")
    if B * H > MAX_GRID_Y:
        raise ValueError(f"B*H={B * H} exceeds the grid's {MAX_GRID_Y}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head size {D} not built; built: {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} must be float32 or bfloat16, as q; got "
                            f"{t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
        # the tensor-core kernel copies bf16 tiles by TMA: base address and
        # byte strides multiples of 16
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
            raise ValueError(f"{name}'s bf16 rows must be 16-byte aligned "
                             f"(base pointer and strides)")


def launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    """Launch on PyTorch's current stream (no synchronise). Raises on what
    the kernel does not take and on a launch error."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash_attention kernel runs on CUDA, got "
                         f"{q.device}")
    check_inputs(q, k, v)
    B, S, H, D = q.shape
    KH = k.shape[2]
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    stream = stream_handle(q.device)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        KH, D, DTYPES[q.dtype], int(bool(causal)), D ** -0.5,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
