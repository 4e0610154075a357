"""Softmax attention forward: the Hopper kernel's launcher.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_kernel`` / ``flash_attention``). The kernel is CUDA C++ in
``csrc/flash_attention.cu`` (its header holds the design and the bound:
137 GFLOP at B*H=64, S=4096, hd=64 causal, about 0.14 ms of bf16
tensor-core work on an H100 SXM), compiled by
:func:`repro_torch.kernels.ops.build_library` and called here through its
plain C interface with ``ctypes``.

It takes the model's layout: q ``(B, S, H, Dqk)``, k ``(B, S, KH, Dqk)``
and v ``(B, S, KH, Dv)`` with ``H % KH == 0``, read through their strides
(last dimension contiguous; bf16 rows 16-byte aligned, as every fresh or
packed projection's are: the bf16 kernel copies tiles by TMA through
tensor maps that its launch function builds from these strides), and
returns a contiguous ``(B, S, H, Dv)`` tensor in q's dtype. The q.k width
``Dqk`` and the v width ``Dv`` are equal (the head size) but under
multi-head latent attention (``models/mla.py``: 96 and 64 for
minicpm3-4b, 192 and 128 for deepseek-v2-236b); the forward library is
built for the pairs in :data:`HEAD_DIMS`, the backward's for those in
:data:`BWD_HEAD_DIMS`.
The reference's wrapper takes ``(B, H, S, D)``; the math is the same:
scale ``Dqk**-0.5``, causal mask ``-1e30``, f32 accumulation, denominator
clamped at ``1e-30``.

For training the forward also writes each query row's log-sum-exp
(natural log, f32 ``(B, H, S)``), and :func:`launch_bwd` runs the
backward kernel of ``csrc/flash_attention_bwd.cu`` (a library of its own;
the reference has no Pallas backward: it differentiates its pure-jnp
attention) on the saved q, k, v, o and log-sum-exp and the output's
gradient, returning dq, dk and dv in q's, k's and v's shapes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import stream_handle
from repro_torch.kernels import counting
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the (q.k width, v width) pairs the forward library is built for
# (FA_PAIRS in csrc/flash_attention.cu): the GQA head sizes 64 and 128
# (zamba2-1.2b, olmo-1b, phi4-mini-3.8b, llama4-scout-17b-a16e) and 96
# (phi3-mini-3.8b); minicpm3-4b's MLA at full and reduced width (the
# reduced deepseek-v2-236b's too), and deepseek-v2-236b's at full width
HEAD_DIMS = ((64, 64), (128, 128), (96, 96), (96, 64), (48, 32), (192, 128))
# the pairs of the backward library (FA_PAIRS in
# csrc/flash_attention_bwd.cu): the forward's; in bf16 (192, 128) runs a
# design of its own (flash_bwd_wgmma_wide: 64-key tiles, S^T and dP^T split
# by query columns between the two consumer warpgroups, dK and dV by
# column boxes)
BWD_HEAD_DIMS = HEAD_DIMS
MAX_GRID_Y = 65535        # one CTA row per (batch, head)

__all__ = ["BWD_HEAD_DIMS", "DTYPES", "HEAD_DIMS", "bind", "bind_bwd",
           "check_inputs", "check_bwd_inputs", "fake", "fake_bwd", "launch",
           "launch_bwd", "kernel_ready"]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature (pointers and the stream as ``c_void_p``)."""
    p, i32, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
    lib.flash_attention_launch.argtypes = (
        [p] * 5 + [i32] * 8 + [f] + [i64] * 9 + [p])
    lib.flash_attention_launch.restype = i32
    return lib


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the backward library's C signature."""
    p, i32, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
    lib.flash_attention_bwd_launch.argtypes = (
        [p] * 11 + [i32] * 8 + [f] + [i64] * 15 + [p])
    lib.flash_attention_bwd_launch.restype = i32
    return lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Raise on what the kernel does not take (on any device)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be 4-d: (B, S, H, Dqk), "
                         "(B, S, KH, Dqk), (B, S, KH, Dv)")
    B, S, H, D = q.shape
    KH, Dv = k.shape[2], v.shape[3]
    if k.shape != (B, S, KH, D) or v.shape != (B, S, KH, Dv):
        raise ValueError(f"k must have shape {(B, S, KH, D)} and v "
                         f"{(B, S, KH)} and a width, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if KH == 0 or H % KH:
        raise ValueError(f"H={H} must be a multiple of KH={KH}")
    if B * H > MAX_GRID_Y:
        raise ValueError(f"B*H={B * H} exceeds the grid's {MAX_GRID_Y}")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"head size (q.k, v widths) {(D, Dv)} not built; "
                         f"built: {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q)


def _check_operand(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    if t.dtype not in DTYPES or t.dtype != q.dtype:
        raise TypeError(f"{name} must be float32 or bfloat16, as q; got "
                        f"{t.dtype}")
    if t.device != q.device:
        raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if not kernel_ready(t):
        raise ValueError(f"{name}'s last dimension must be contiguous, and "
                         f"bf16 rows 16-byte aligned (base pointer and "
                         f"strides)")


def kernel_ready(t: torch.Tensor) -> bool:
    """Whether the kernels take ``t``'s layout: the last dimension
    contiguous and, in bf16, the base address and byte strides multiples
    of 16 (the tensor-core forward copies bf16 tiles by TMA). A gradient
    that arrives from a ``reshape`` or a ``view`` may fail this; the
    backward's caller makes it contiguous first."""
    if t.stride(-1) != 1:
        return False
    return t.dtype != torch.bfloat16 or not (
        t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]))


def check_bwd_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor,
                     do: torch.Tensor) -> None:
    """Raise on what the backward kernel does not take: q, k, v as the
    forward's, at a width pair of :data:`BWD_HEAD_DIMS`; o and do shaped
    as the forward's output ``(B, S, H, Dv)`` and typed as q, under q's
    rules; lse a contiguous f32 ``(B, H, S)``."""
    check_inputs(q, k, v)
    if (q.shape[3], v.shape[3]) not in BWD_HEAD_DIMS:
        raise ValueError(f"the attention backward kernel is not built for "
                         f"the (q.k, v) widths {(q.shape[3], v.shape[3])}; "
                         f"built: {BWD_HEAD_DIMS}")
    out_shape = q.shape[:3] + v.shape[3:]
    for name, t in (("o", o), ("do", do)):
        if t.shape != out_shape:
            raise ValueError(f"{name} must have the output's shape "
                             f"{tuple(out_shape)}, got {tuple(t.shape)}")
        _check_operand(name, t, q)
    B, S, H, _ = q.shape
    if (lse.shape != (B, H, S) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 {(B, H, S)} "
                         f"tensor on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")


def launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, *, causal: bool = True, with_lse: bool = False):
    """Launch on PyTorch's current stream (no synchronise). Returns the
    output, or ``(out, lse)`` with ``with_lse`` (each query row's
    natural-log log-sum-exp, f32 ``(B, H, S)``; without it the kernel is
    passed a null pointer and writes none). Raises on what the kernel does
    not take and on a launch error."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash_attention kernel runs on CUDA, got "
                         f"{q.device}")
    check_inputs(q, k, v)
    B, S, H, D = q.shape
    KH, Dv = k.shape[2], v.shape[3]
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = stream_handle(q.device)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, S, H,
        KH, D, Dv, DTYPES[q.dtype], int(bool(causal)), D ** -0.5,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return (out, lse) if with_lse else out


def launch_bwd(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
               do: torch.Tensor, *, causal: bool = True):
    """The backward kernel on PyTorch's current stream (no synchronise):
    ``(dq, dk, dv)``, contiguous, in q's dtype and q's / k's / v's shapes.
    Allocates the f32 scratch: the rows' ``rowsum(do * o)`` and, for bf16,
    dq's f32 accumulator (an f32 dq is accumulated in place). Raises on
    what the kernel does not take and on a launch error."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash_attention_bwd kernel runs on CUDA, "
                         f"got {q.device}")
    check_bwd_inputs(q, k, v, o, lse, do)
    B, S, H, D = q.shape
    KH, Dv = k.shape[2], v.shape[3]
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, KH, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S, KH, Dv), dtype=q.dtype, device=q.device)
    dq_acc = dq if q.dtype == torch.float32 else torch.empty(
        (B, S, H, D), dtype=torch.float32, device=q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    stream = stream_handle(q.device)
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dq_acc.data_ptr(), delta.data_ptr(), B, S, H, KH, D,
        Dv, DTYPES[q.dtype], int(bool(causal)), D ** -0.5,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"CUDA error {err}")
    return dq, dk, dv


def fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, with_lse: bool = False):
    """The fake route (``kernels/counting.py``): what :func:`launch`
    returns, on q's fake device, with the plain version's dot FLOPs
    reported (``counting.attention_flops``); nothing is launched. Raises on
    a width pair the library is not built for, as the launch would."""
    B, S, H, D = q.shape
    Dv = v.shape[3]
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"head size (q.k, v widths) {(D, Dv)} not built; "
                         f"built: {HEAD_DIMS}")
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)
    counting.report("flash_attention",
                    counting.attention_flops(B, S, H, D, Dv))
    if not with_lse:
        return out
    return out, torch.empty((B, H, S), dtype=torch.float32, device=q.device)


def fake_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
             causal: bool = True):
    """The backward's fake route: :func:`launch_bwd`'s outputs and f32
    scratch on q's fake device, the plain version's dot FLOPs reported
    (``counting.attention_bwd_flops``); nothing is launched."""
    B, S, H, D = q.shape
    KH, Dv = k.shape[2], v.shape[3]
    if (D, Dv) not in BWD_HEAD_DIMS:
        raise ValueError(f"the attention backward kernel is not built for "
                         f"the (q.k, v) widths {(D, Dv)}; built: "
                         f"{BWD_HEAD_DIMS}")
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, KH, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S, KH, Dv), dtype=q.dtype, device=q.device)
    if q.dtype != torch.float32:
        torch.empty((B, S, H, D), dtype=torch.float32, device=q.device)
    torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    counting.report("flash_attention_bwd",
                    counting.attention_bwd_flops(B, S, H, D, Dv))
    return dq, dk, dv
