"""Mamba2 / SSD chunked scan: the Hopper kernel's launcher.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_chunk.py``
(``_ssd_kernel`` / ``ssd_chunk``). The kernel is CUDA C++ in
``csrc/ssd_chunk.cu`` (its header holds the design and the bound: about
138 MB moved at B=2, S=4096, nh=64, hd=64, ds=64 in bf16, 0.041 ms at an
H100 SXM's 3.35 TB/s): bf16 runs on the tensor cores with hd cut into two
column slices, one CTA each; f32 on scalar FMAs. It is compiled by
:func:`repro_torch.kernels.ops.build_library` and called through its plain
C interface with ``ctypes``.

``x``: ``(B, S, nh, hd)``; ``Bm``, ``Cm``: ``(B, S, ds)`` in x's dtype (one
group shared by all heads); ``dt``: ``(B, S, nh)`` and ``A``: ``(nh,)``,
both cast to float32 as the reference's wrapper does. Inputs are read
through their strides (last dimension contiguous), so slices of the
model's packed projection need no copy. Returns a contiguous
``(B, S, nh, hd)`` tensor in x's dtype; all arithmetic is float32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import stream_handle
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64,)          # hd the library is built for
STATE_DIMS = (16, 64, 128)  # ds the library is built for
MAX_GRID_Z = 65535          # the batch is the grid's z axis

__all__ = ["DTYPES", "HEAD_DIMS", "STATE_DIMS", "bind", "launch"]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature (pointers and the stream as ``c_void_p``)."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_chunk_launch.argtypes = [p] * 6 + [i32] * 6 + [i64] * 10 + [p]
    lib.ssd_chunk_launch.restype = i32
    return lib


def launch(lib: ctypes.CDLL, x: torch.Tensor, Bm: torch.Tensor,
           Cm: torch.Tensor, dt: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Launch on PyTorch's current stream (no synchronise). Raises on what
    the kernel does not take and on a launch error."""
    if x.device.type != "cuda":
        raise ValueError(f"the ssd_chunk kernel runs on CUDA, got {x.device}")
    if x.ndim != 4:
        raise ValueError(f"x must be (B, S, nh, hd), got {tuple(x.shape)}")
    B, S, NH, HD = x.shape
    DS = Bm.shape[-1]
    dt = dt.to(torch.float32)
    A = A.to(torch.float32).contiguous()
    if Bm.shape != (B, S, DS) or Cm.shape != (B, S, DS):
        raise ValueError(f"Bm, Cm must have shape {(B, S, DS)}, got "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if dt.shape != (B, S, NH) or A.shape != (NH,):
        raise ValueError(f"dt must be {(B, S, NH)} and A {(NH,)}, got "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}")
    if HD not in HEAD_DIMS or DS not in STATE_DIMS:
        raise ValueError(f"(hd, ds)=({HD}, {DS}) not built; built: hd in "
                         f"{HEAD_DIMS}, ds in {STATE_DIMS}")
    if B > MAX_GRID_Z:
        raise ValueError(f"batch {B} exceeds the grid's {MAX_GRID_Z}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm), ("dt", dt), ("A", A)):
        if name in ("Bm", "Cm") and t.dtype != x.dtype:
            raise TypeError(f"{name} must have x's dtype {x.dtype}, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    y = torch.empty((B, S, NH, HD), dtype=x.dtype, device=x.device)
    stream = stream_handle(x.device)
    err = lib.ssd_chunk_launch(
        x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
        A.data_ptr(), y.data_ptr(), B, S, NH, HD, DS, DTYPES[x.dtype],
        *x.stride()[:3], *Bm.stride()[:2], *Cm.stride()[:2],
        *dt.stride(), stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error {err}")
    return y
