"""Mamba1 selective scan: the Hopper kernel's launcher.

Replaces the Pallas TPU kernel ``repro/kernels/selective_scan.py``
(``_scan_kernel`` / ``selective_scan``). The kernel is CUDA C++ in
``csrc/selective_scan.cu`` (its header holds the design and the bound: at
B=2, S=4096, di=8192, ds=16 in bf16, 1,073,741,824 exponentials, about
0.257 ms on an H100 SXM's special-function units at 1,980 MHz, above the
0.1205 ms its 404 MB take at 3.35 TB/s), compiled by
:func:`repro_torch.kernels.ops.build_library` and called through its plain
C interface with ``ctypes``.

``x``, ``dt``: ``(B, S, di)``; ``Bm``, ``Cm``: ``(B, S, ds)``, all four in
one dtype (float32 or bfloat16); ``A``: ``(di, ds)`` and ``D``: ``(di,)``,
cast to float32 as the reference's wrapper does. Inputs are read through
their batch and sequence strides (last dimension contiguous), so slices of
the model's packed projection need no copy. Any di is taken (the last
CTA's channels are masked). Returns a contiguous ``(B, S, di)`` tensor in
x's dtype, with the D skip; all arithmetic is float32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import stream_handle
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIMS = (8, 16)        # ds the library is built for
MAX_GRID_Y = 65535          # one CTA row per batch element

__all__ = ["DTYPES", "STATE_DIMS", "bind", "launch"]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature (pointers and the stream as ``c_void_p``)."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.selective_scan_launch.argtypes = [p] * 7 + [i32] * 5 + [i64] * 8 + [p]
    lib.selective_scan_launch.restype = i32
    return lib


def launch(lib: ctypes.CDLL, x: torch.Tensor, dt: torch.Tensor,
           Bm: torch.Tensor, Cm: torch.Tensor, A: torch.Tensor,
           D: torch.Tensor) -> torch.Tensor:
    """Launch on PyTorch's current stream (no synchronise). Raises on what
    the kernel does not take and on a launch error."""
    if x.device.type != "cuda":
        raise ValueError(f"the selective_scan kernel runs on CUDA, got "
                         f"{x.device}")
    if x.ndim != 3:
        raise ValueError(f"x must be (B, S, di), got {tuple(x.shape)}")
    B, S, DI = x.shape
    DS = Bm.shape[-1]
    A = A.to(torch.float32).contiguous()
    D = D.to(torch.float32).contiguous()
    if dt.shape != x.shape:
        raise ValueError(f"dt must have x's shape {tuple(x.shape)}, got "
                         f"{tuple(dt.shape)}")
    if Bm.shape != (B, S, DS) or Cm.shape != (B, S, DS):
        raise ValueError(f"Bm, Cm must have shape {(B, S, DS)}, got "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if A.shape != (DI, DS) or D.shape != (DI,):
        raise ValueError(f"A must be {(DI, DS)} and D {(DI,)}, got "
                         f"{tuple(A.shape)}, {tuple(D.shape)}")
    if DS not in STATE_DIMS:
        raise ValueError(f"ds={DS} not built; built: ds in {STATE_DIMS}")
    if B * S * DI == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if B > MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds the grid's {MAX_GRID_Y}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("x", x), ("dt", dt), ("Bm", Bm), ("Cm", Cm), ("A", A),
                    ("D", D)):
        if name in ("dt", "Bm", "Cm") and t.dtype != x.dtype:
            raise TypeError(f"{name} must have x's dtype {x.dtype}, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    y = torch.empty((B, S, DI), dtype=x.dtype, device=x.device)
    stream = stream_handle(x.device)
    err = lib.selective_scan_launch(
        x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        A.data_ptr(), D.data_ptr(), y.data_ptr(), B, S, DI, DS,
        DTYPES[x.dtype], *x.stride()[:2], *dt.stride()[:2],
        *Bm.stride()[:2], *Cm.stride()[:2], stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA "
                           f"error {err}")
    return y
