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
``(B, S, nh, hd)`` tensor in x's dtype; all arithmetic is float32. With
``with_states`` (under grad) it also returns the float32 state entering
each 64-step chunk, ``(B, ceil(S / 64), nh, ds, hd)``, which the
backward kernel reads.

The backward, ``csrc/ssd_chunk_bwd.cu`` (its own library, bound by
:func:`bind_bwd`, launched by :func:`launch_bwd`; its header holds the
designs and the bound: about 419 MB moved at zamba2-1.2b's train step,
B=4, S=4096, nh=64, hd=64, ds=64 in bf16, 0.125 ms at 3.35 TB/s), has no
Pallas counterpart: the reference differentiates its pure-jnp SSD. In bf16
one call runs two kernels: the carry pass (the gradient each chunk's last
state receives from the later chunks, K, into a float32 scratch buffer of
the states' shape; :func:`launch_carry` runs it alone) and the
chunk-local gradients on the tensor cores; f32 runs the scalar kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import stream_handle
from repro_torch.kernels import counting
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64,)          # hd the library is built for
STATE_DIMS = (16, 64, 128)  # ds the library is built for
MAX_GRID_Z = 65535          # the batch is the grid's z axis
CHUNK = 64                  # the kernels' chunk: one state written each

__all__ = ["CHUNK", "DTYPES", "HEAD_DIMS", "STATE_DIMS", "bind",
           "bind_bwd", "fake", "fake_bwd", "launch", "launch_bwd",
           "launch_carry"]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature (pointers and the stream as ``c_void_p``)."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_chunk_launch.argtypes = [p] * 7 + [i32] * 6 + [i64] * 10 + [p]
    lib.ssd_chunk_launch.restype = i32
    return lib


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the backward library's C signature."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_chunk_bwd_launch.argtypes = ([p] * 13 + [i32] * 6 + [i64] * 13
                                         + [p])
    lib.ssd_chunk_bwd_launch.restype = i32
    lib.ssd_chunk_bwd_carry_launch.argtypes = ([p] * 5 + [i32] * 5
                                               + [i64] * 8 + [p])
    lib.ssd_chunk_bwd_carry_launch.restype = i32
    return lib


def _check(x, Bm, Cm, dt, A):
    """Raise on what the kernels do not take; returns dt and A as f32."""
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
    return dt, A


def launch(lib: ctypes.CDLL, x: torch.Tensor, Bm: torch.Tensor,
           Cm: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, *,
           with_states: bool = False):
    """Launch on PyTorch's current stream (no synchronise): y, or ``(y,
    states)`` with ``with_states``. Raises on what the kernel does not
    take and on a launch error."""
    dt, A = _check(x, Bm, Cm, dt, A)
    B, S, NH, HD = x.shape
    DS = Bm.shape[-1]
    y = torch.empty((B, S, NH, HD), dtype=x.dtype, device=x.device)
    states = (torch.empty((B, -(-S // CHUNK), NH, DS, HD),
                          dtype=torch.float32, device=x.device)
              if with_states else None)
    stream = stream_handle(x.device)
    err = lib.ssd_chunk_launch(
        x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
        A.data_ptr(), y.data_ptr(),
        None if states is None else states.data_ptr(), B, S, NH, HD, DS,
        DTYPES[x.dtype], *x.stride()[:3], *Bm.stride()[:2],
        *Cm.stride()[:2], *dt.stride(), stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error {err}")
    return (y, states) if with_states else y


def _copyable(t: torch.Tensor) -> bool:
    """Rows the bf16 backward kernels copy 16 bytes at a time: a 16-byte
    aligned start and strides of whole 8-element pieces."""
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0
                                          for st in t.stride()[:-1])


def _copied(t: torch.Tensor) -> torch.Tensor:
    return t if _copyable(t) else t.clone(
        memory_format=torch.contiguous_format)


def launch_bwd(lib: ctypes.CDLL, x: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               dy: torch.Tensor, states: torch.Tensor):
    """The backward on PyTorch's current stream (no synchronise): ``(dx,
    dBm, dCm, ddt, dA)``, dx in x's dtype, dBm and dCm in their inputs'
    dtype (summed over the heads in f32, then cast), ddt and dA in f32.
    ``states`` is the forward's (``launch(..., with_states=True)``); ``dy``
    is read through its strides (last dimension contiguous). In bf16 the
    carry pass writes a float32 buffer of the states' shape (freed on
    return) and dA comes as a part a (batch, chunk, head), summed here; a
    bf16 x, B, C or dy whose rows are not 16-byte aligned is copied first.
    Raises on what the kernels do not take and on a launch error."""
    dt, A = _check(x, Bm, Cm, dt, A)
    B, S, NH, HD = x.shape
    DS = Bm.shape[-1]
    n_chunks = -(-S // CHUNK)
    want = (B, n_chunks, NH, DS, HD)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}, got {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device}")
    if dy.stride(-1) != 1:
        raise ValueError("dy's last dimension must be contiguous")
    if (tuple(states.shape) != want or states.dtype != torch.float32
            or not states.is_contiguous() or states.device != x.device
            or states.data_ptr() % 16):
        raise ValueError(f"states must be a contiguous, 16-byte aligned "
                         f"float32 {want} on {x.device}, got {states.dtype} "
                         f"{tuple(states.shape)}")
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        x, Bm, Cm, dy = map(_copied, (x, Bm, Cm, dy))
    dev = x.device
    dx = torch.empty((B, S, NH, HD), dtype=x.dtype, device=dev)
    dBf = torch.empty((B, S, DS), dtype=torch.float32, device=dev)
    dCf = torch.empty_like(dBf)
    ddt = torch.empty((B, S, NH), dtype=torch.float32, device=dev)
    carry = torch.empty(want, dtype=torch.float32, device=dev) if bf16 \
        else None
    dA = torch.empty((B * n_chunks, NH), dtype=torch.float32, device=dev) \
        if bf16 else torch.zeros((NH,), dtype=torch.float32, device=dev)
    err = lib.ssd_chunk_bwd_launch(
        x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
        A.data_ptr(), dy.data_ptr(), states.data_ptr(),
        None if carry is None else carry.data_ptr(), dx.data_ptr(),
        dBf.data_ptr(), dCf.data_ptr(), ddt.data_ptr(), dA.data_ptr(), B, S,
        NH, HD, DS, DTYPES[x.dtype], *x.stride()[:3], *Bm.stride()[:2],
        *Cm.stride()[:2], *dt.stride(), *dy.stride()[:3], stream_handle(dev))
    if err != 0:
        raise RuntimeError(f"ssd_chunk_bwd kernel launch failed: CUDA error "
                           f"{err}")
    return (dx, dBf.to(Bm.dtype), dCf.to(Cm.dtype), ddt,
            dA.sum(0) if bf16 else dA)


def launch_carry(lib: ctypes.CDLL, Cm: torch.Tensor, dt: torch.Tensor,
                 A: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The bf16 backward's carry pass alone (its check against
    ``ref.ssd_chunk_bwd_carry``): the float32 gradient each chunk's last
    state receives from the later chunks, ``(B, ceil(S / 64), nh, ds,
    hd)``, from bf16 C ``(B, S, ds)`` and dy ``(B, S, nh, hd)``, dt and A.
    Raises on what the kernel does not take and on a launch error."""
    dt, A = _check(dy, Cm, Cm, dt, A)   # dy in x's place: (B, S, nh, hd)
    if dy.dtype != torch.bfloat16:
        raise TypeError(f"the carry pass is the bf16 route's, got "
                        f"{dy.dtype}")
    Cm, dy = _copied(Cm), _copied(dy)
    B, S, NH, HD = dy.shape
    DS = Cm.shape[-1]
    carry = torch.empty((B, -(-S // CHUNK), NH, DS, HD), dtype=torch.float32,
                        device=dy.device)
    err = lib.ssd_chunk_bwd_carry_launch(
        Cm.data_ptr(), dt.data_ptr(), A.data_ptr(), dy.data_ptr(),
        carry.data_ptr(), B, S, NH, HD, DS, *Cm.stride()[:2], *dt.stride(),
        *dy.stride()[:3], stream_handle(dy.device))
    if err != 0:
        raise RuntimeError(f"ssd_chunk_bwd carry launch failed: CUDA error "
                           f"{err}")
    return carry


def fake(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
         dt: torch.Tensor, A: torch.Tensor, *, with_states: bool = False):
    """The fake route (``kernels/counting.py``): what :func:`launch`
    returns, on x's fake device, with the plain version's dot FLOPs
    reported (``counting.ssd_flops``); nothing is launched."""
    B, S, NH, HD = x.shape
    DS = Bm.shape[-1]
    y = torch.empty((B, S, NH, HD), dtype=x.dtype, device=x.device)
    counting.report("ssd_chunk", counting.ssd_flops(B, S, NH, HD, DS))
    if not with_states:
        return y
    return y, torch.empty((B, -(-S // CHUNK), NH, DS, HD),
                          dtype=torch.float32, device=x.device)


def fake_bwd(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, dy: torch.Tensor):
    """The backward's fake route: :func:`launch_bwd`'s outputs, f32 parts
    and (bf16) carry buffer on x's fake device, the plain version's dot
    FLOPs reported (``counting.ssd_bwd_flops``); nothing is launched."""
    B, S, NH, HD = x.shape
    DS = Bm.shape[-1]
    n_chunks = -(-S // CHUNK)
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    dx = torch.empty((B, S, NH, HD), dtype=x.dtype, device=dev)
    dBf = torch.empty((B, S, DS), dtype=torch.float32, device=dev)
    dCf = torch.empty_like(dBf)
    ddt = torch.empty((B, S, NH), dtype=torch.float32, device=dev)
    if bf16:
        torch.empty((B, n_chunks, NH, DS, HD), dtype=torch.float32,
                    device=dev)
    dA = torch.empty((B * n_chunks, NH) if bf16 else (NH,),
                     dtype=torch.float32, device=dev)
    counting.report("ssd_chunk_bwd", counting.ssd_bwd_flops(B, S, NH, HD, DS))
    return (dx, dBf.to(Bm.dtype), dCf.to(Cm.dtype), ddt,
            dA.sum(0) if bf16 else dA)
