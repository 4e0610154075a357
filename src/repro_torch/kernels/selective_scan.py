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
x's dtype, with the D skip; all arithmetic is float32. With
``with_states`` (under grad) it also returns the float32 state entering
each 64-step tile, ``(B, ceil(S / 64), di, ds)``, which the backward
kernel reads.

The backward kernel, ``csrc/selective_scan_bwd.cu`` (its own library,
bound by :func:`bind_bwd`, launched by :func:`launch_bwd`; its header
holds the design and the bound: at falcon-mamba-7b's train step, B=4,
S=4096, di=8192, ds=16 in bf16, 2,147,483,648 exponentials, about 0.514
ms at 1,980 MHz, above the 0.401 ms its 1.34 GB take), has no Pallas
counterpart: the reference differentiates its ``lax.scan``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import stream_handle
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIMS = (8, 16)        # ds the library is built for
MAX_GRID_Y = 65535          # one CTA row per batch element
TILE = 64                   # the kernels' tile: one state written each

__all__ = ["DTYPES", "STATE_DIMS", "TILE", "bind", "bind_bwd", "launch",
           "launch_bwd"]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature (pointers and the stream as ``c_void_p``)."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.selective_scan_launch.argtypes = [p] * 8 + [i32] * 5 + [i64] * 8 + [p]
    lib.selective_scan_launch.restype = i32
    return lib


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the backward library's C signature."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.selective_scan_bwd_launch.argtypes = ([p] * 14 + [i32] * 5
                                              + [i64] * 10 + [p])
    lib.selective_scan_bwd_launch.restype = i32
    return lib


def _check(x, dt, Bm, Cm, A, D):
    """Raise on what the kernels do not take; returns A and D as f32."""
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
    return A, D


def launch(lib: ctypes.CDLL, x: torch.Tensor, dt: torch.Tensor,
           Bm: torch.Tensor, Cm: torch.Tensor, A: torch.Tensor,
           D: torch.Tensor, *, with_states: bool = False):
    """Launch on PyTorch's current stream (no synchronise): y, or ``(y,
    states)`` with ``with_states``. Raises on what the kernel does not
    take and on a launch error."""
    A, D = _check(x, dt, Bm, Cm, A, D)
    B, S, DI = x.shape
    DS = Bm.shape[-1]
    y = torch.empty((B, S, DI), dtype=x.dtype, device=x.device)
    states = (torch.empty((B, -(-S // TILE), DI, DS), dtype=torch.float32,
                          device=x.device) if with_states else None)
    stream = stream_handle(x.device)
    err = lib.selective_scan_launch(
        x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        A.data_ptr(), D.data_ptr(), y.data_ptr(),
        None if states is None else states.data_ptr(), B, S, DI, DS,
        DTYPES[x.dtype], *x.stride()[:2], *dt.stride()[:2],
        *Bm.stride()[:2], *Cm.stride()[:2], stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA "
                           f"error {err}")
    return (y, states) if with_states else y


def launch_bwd(lib: ctypes.CDLL, x: torch.Tensor, dt: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor, A: torch.Tensor,
               D: torch.Tensor, dy: torch.Tensor, states: torch.Tensor):
    """The backward kernel on PyTorch's current stream (no synchronise):
    ``(dx, ddt, dBm, dCm, dA, dD)``, dx and ddt in x's dtype, dBm and dCm
    in theirs (summed over the channels in f32, then cast), dA and dD in
    f32. ``states`` is the forward's (``launch(..., with_states=True)``);
    ``dy`` is read through its batch and sequence strides (last dimension
    contiguous). Raises on what the kernel does not take and on a launch
    error."""
    A, D = _check(x, dt, Bm, Cm, A, D)
    B, S, DI = x.shape
    DS = Bm.shape[-1]
    want = (B, -(-S // TILE), DI, DS)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}, got {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device}")
    if dy.stride(-1) != 1:
        raise ValueError("dy's last dimension must be contiguous")
    if (tuple(states.shape) != want or states.dtype != torch.float32
            or not states.is_contiguous() or states.device != x.device):
        raise ValueError(f"states must be a contiguous float32 {want} on "
                         f"{x.device}, got {states.dtype} "
                         f"{tuple(states.shape)}")
    dx = torch.empty((B, S, DI), dtype=x.dtype, device=x.device)
    ddt = torch.empty_like(dx)
    dBf = torch.zeros((B, S, DS), dtype=torch.float32, device=x.device)
    dCf = torch.zeros_like(dBf)
    dA = torch.zeros((DI, DS), dtype=torch.float32, device=x.device)
    dD = torch.zeros((DI,), dtype=torch.float32, device=x.device)
    stream = stream_handle(x.device)
    err = lib.selective_scan_bwd_launch(
        x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        A.data_ptr(), D.data_ptr(), dy.data_ptr(), states.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), dBf.data_ptr(), dCf.data_ptr(),
        dA.data_ptr(), dD.data_ptr(), B, S, DI, DS, DTYPES[x.dtype],
        *x.stride()[:2], *dt.stride()[:2], *Bm.stride()[:2],
        *Cm.stride()[:2], *dy.stride()[:2], stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd kernel launch failed: CUDA "
                           f"error {err}")
    return dx, ddt, dBf.to(Bm.dtype), dCf.to(Cm.dtype), dA, dD
