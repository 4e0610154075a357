"""Float32 arithmetic shared by the port's exact-parity paths.

The reference runs under XLA's CPU compiler, which contracts ``x * y + z``
into one fused multiply-add (a single rounding). PyTorch has no
elementwise FMA, so :func:`fma` evaluates it in float64: the float32
product ``x * y`` is exact there (48 significant bits), and the sum is
rounded once more to float32. That is the FMA's result except in a double
rounding tie, which needs the float64 sum to land exactly on a float32
midpoint (about one case in 2**28 when the exact sum needs more than 53
bits). The CUDA kernel evaluates the same float64 expression, so kernel
and plain version agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.analysis.runtime import setup_transfers


def f32(x, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor on ``like``'s device: a Python float rounded
    once to float32, as JAX rounds a weakly-typed scalar. Filled on the
    device (no host-to-device copy), so a CUDA graph can capture it."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


_CONSTANTS: Dict[Tuple[Any, torch.dtype, torch.device], torch.Tensor] = {}


def constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A constant table (nested tuples of Python numbers) on ``device``,
    made once per (table, dtype, device) and kept: a round step replayed
    from a CUDA graph reads it and copies nothing from the host. Never
    write to it."""
    key = (values, dtype, torch.device(device))
    if key not in _CONSTANTS:
        with setup_transfers():     # copied once, outside any capture
            _CONSTANTS[key] = torch.tensor(values, dtype=dtype,
                                           device=device)
    return _CONSTANTS[key]


def fma(x, y, z) -> torch.Tensor:
    """``x * y + z`` with one float32 rounding (see module docstring).
    A Python ``x`` is first rounded to float32, like any weak scalar."""
    d = torch.float64
    if not torch.is_tensor(x):
        x = f32(x, y)
    return (x.to(d) * y.to(d) + z.to(d)).to(torch.float32)


def orderable_key(x: torch.Tensor) -> torch.Tensor:
    """The float32 ``x``'s 32 bits mapped so that unsigned order is
    ``lax.top_k``'s total order: ``bits ^ (sign ? 0xFFFFFFFF :
    0x80000000)``, returned as int64 in ``[0, 2**32)``. -NaN < -inf < ...
    < -0 < +0 < ... < +inf < +NaN (NaNs further by payload). The CUDA
    top-k kernel radix-selects on the same key."""
    if x.dtype != torch.float32:
        raise TypeError(f"orderable_key takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    flip = torch.where(bits >= 0x80000000, 0xFFFFFFFF, 0x80000000)
    return bits ^ flip


_POWF_TABLE = 1 << 12
_DAMPING: Dict[Tuple[float, torch.device], torch.Tensor] = {}


def _powf_table(exponent: float, device: torch.device) -> torch.Tensor:
    """``powf(1 + s, exponent)`` for s in ``[0, 4096)``, from the C
    library, made once per (exponent, device) and kept (a replayed step
    reads it and copies nothing from the host)."""
    key = (exponent, torch.device(device))
    if key not in _DAMPING:
        powf = ctypes.CDLL(None).powf
        powf.restype, powf.argtypes = ctypes.c_float, [ctypes.c_float] * 2
        table = np.array([powf(1.0 + s, exponent)
                          for s in range(_POWF_TABLE)], np.float32)
        with setup_transfers():     # copied once, outside any capture
            _DAMPING[key] = torch.from_numpy(table).to(device)
    return _DAMPING[key]


def staleness_damping(staleness: torch.Tensor, power: float) -> torch.Tensor:
    """FedBuff's damping ``(1 + s) ** -power`` in float32, for integer
    staleness ``s >= 0``, as XLA's CPU build evaluates the reference's
    expression. XLA folds ``pow(x, -0.0)`` to 1 and rewrites ``pow(x,
    -1)`` as the division ``1 / x``; any other exponent becomes a call of
    the C library's ``powf`` (glibc's, below one ulp but not correctly
    rounded: a float64 power rounded once differs from it, first at s =
    17 for power 1.5, and ``torch.pow`` in float32 at s = 5 for power
    0.5). So ``powf`` is read from a table of its values; a staleness
    beyond the table (4096 aggregations) takes the float64 power rounded
    once."""
    x = 1.0 + staleness.to(torch.float32)
    if power == 0.0:
        return torch.ones_like(x)
    if power == 1.0:
        return f32(1.0, x) / x
    exponent = float(np.float32(-power))    # the reference's f32 constant
    table = _powf_table(exponent, x.device)
    inside = staleness < _POWF_TABLE
    near = table[torch.clamp(staleness.long(), 0, _POWF_TABLE - 1)]
    far = torch.pow(x.to(torch.float64), exponent).to(torch.float32)
    return torch.where(inside, near, far)
