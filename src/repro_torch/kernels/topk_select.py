"""EAFL reward + exact top-k client selection: the Hopper kernel's launcher.

Replaces the Pallas TPU kernel ``repro/kernels/topk_select.py``
(``_topk_kernel`` / ``topk_reward``). The kernel is CUDA C++ in
``csrc/topk_select.cu`` (its header comment holds the design, a radix
select in shared memory over tiles of clients and then over their
candidate lists, and the bound: 13 bytes read per client, about 4.1 us at
1,048,576 clients on an H100 SXM at 3.35 TB/s), compiled by
:func:`repro_torch.kernels.ops.build_library` and called here through its
plain C interface with ``ctypes``.

What it computes is the reference's function, not its blocks carried over:
a global stable top-k of ``where(valid, mix(a, b) * (1 + ucb), SENTINEL)``
in ``lax.top_k``'s total order (values descending, +0 above -0, +NaN
first, -NaN last; ties lowest index first). The reference's final
``lax.top_k`` over block candidates has exactly that order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import stream_handle
from repro_torch.kernels import counting
from repro_torch.kernels.ref import MODES, SENTINEL

DEFAULT_BLOCK_N = 4096
MAX_BLOCK_N = 8192        # the kernel sorts at most 8192 winners
TILE = 8192               # clients a CTA of the first pass (kTile in the .cu)
MASK_DTYPES = (torch.bool, torch.uint8)   # the kernel reads one byte a client

_READY = set()   # (library, device) pairs with raised shared-memory limits

__all__ = ["DEFAULT_BLOCK_N", "MAX_BLOCK_N", "MODES", "SENTINEL", "TILE",
           "bind", "fake", "launch", "scratch_words"]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures (pointers and the stream as ``c_void_p``,
    so ctypes never truncates them to 32 bits)."""
    p, i32, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
    lib.topk_reward_init.argtypes = []
    lib.topk_reward_init.restype = i32
    lib.topk_reward_launch.argtypes = [p, p, p, p, i64, i32, f, f, i32, i32,
                                       p, i64, p, p, p]
    lib.topk_reward_launch.restype = i32
    return lib


def scratch_words(n: int, k: int) -> int:
    """32-bit scratch words of a launch: two halves of (key, index) for
    each first-pass tile's k candidates, none when one tile holds all N
    (``topk_reward_scratch_words`` in the .cu, which checks it)."""
    tiles = max(1, n // TILE)
    return 4 * tiles * k if tiles > 1 else 0


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
    or uint8. ``block_n`` only bounds ``k`` (as the reference's blocks do):
    the kernel's tiles are its own.
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
    if (lib._name, dev.index) not in _READY:
        with torch.cuda.device(dev):
            err = lib.topk_reward_init()
        if err != 0:
            raise RuntimeError(f"topk_reward kernel set-up failed: CUDA "
                               f"error {err}")
        _READY.add((lib._name, dev.index))
    # the scratch may be freed as soon as this returns: PyTorch's caching
    # allocator hands it only to work queued after the kernel on this
    # stream. Separate allocations cost the host less than views of one.
    words = scratch_words(n, k)
    scratch = torch.empty(words, dtype=torch.int32, device=dev) if words \
        else None
    out_v = torch.empty(k, dtype=torch.float32, device=dev)
    out_i = torch.empty(k, dtype=torch.int32, device=dev)
    err = lib.topk_reward_launch(
        a.data_ptr(), b.data_ptr(), None if ucb is None else ucb.data_ptr(),
        valid.data_ptr(), n, MODES.index(mode), float(f), 1.0 - float(f),
        k, int(index_offset), None if scratch is None else scratch.data_ptr(),
        words, out_v.data_ptr(), out_i.data_ptr(),
        stream_handle(dev))
    if err != 0:
        raise RuntimeError(f"topk_reward kernel launch failed: CUDA error "
                           f"{err}")
    return out_v, out_i


def fake(a: torch.Tensor, *, k: int):
    """The fake route (``kernels/counting.py``): :func:`launch`'s outputs
    on ``a``'s fake device, and its scratch; no dot FLOPs (a selection,
    no products); nothing is launched."""
    words = scratch_words(int(a.shape[0]), k)
    if words:
        torch.empty(words, dtype=torch.int32, device=a.device)
    counting.report("topk_reward", 0)
    return (torch.empty(k, dtype=torch.float32, device=a.device),
            torch.empty(k, dtype=torch.int32, device=a.device))
