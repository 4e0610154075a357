"""Bit-exact threefry2x32 in PyTorch: the reference's random streams.

The JAX package draws every random number from threefry2x32 in its
*partitionable* mode (``repro.core.selection`` sets the flag at import).
This module reproduces that generator bit for bit, so every integer stream
derived from a key (cohort rank bits, minibatch indices, the per-round key
chain, recharge draws, label partitions) is identical in the two packages.

Keys are integer tensors of shape ``(..., 2)`` holding two unsigned 32-bit
words. The arithmetic runs in int64 masked to 32 bits, because
``torch.uint32`` lacks most operators on the CPU. Every sampler is batched
over the leading key dimensions: ``bits(keys (C, 2), (M,))`` is ``(C, M)``,
equal row for row to ``vmap(lambda k: jax.random.bits(k, (M,)))``.

``normal`` goes through ``erfinv`` and is only close to JAX's (the two
``erfinv`` approximations differ in the last bits); parity tests inject the
reference's normal draws where they matter.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.numerics import f32, fma, orderable_key

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds) of counter words ``(x0, x1)``
    under key words ``(k0, k1)``; all int64 tensors holding uint32 values,
    broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed that fits in int32 (the
    reference runs with x64 off, so the high word is always 0). Filled on
    the device, so a CUDA graph can capture it."""
    return torch.arange(2, dtype=torch.int64,
                        device=resolve_device(device)) * (int(seed) & MASK)


def _counters(n: int, device,
              offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    return i >> 32, i & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` -> ``(..., num, 2)``."""
    hi, lo = _counters(num, key.device)
    b0, b1 = threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a scalar ``data``: a Python
    int, or a 0-d integer tensor (say a round counter on the device),
    which is folded in without reading it on the host."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    if torch.is_tensor(data):
        d = data.to(device=key.device, dtype=torch.int64) & MASK
    else:
        d = torch.full((), int(data) & MASK, dtype=torch.int64,
                       device=key.device)
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], zero, d)
    return torch.stack([b0, b1], dim=-1)


def bits(key: torch.Tensor, shape: Shape, offset: int = 0) -> torch.Tensor:
    """32 random bits per element (``jax.random.bits``, uint32), as int64.
    Output shape is ``key.shape[:-1] + shape``. The stream is
    counter-based and prefix-stable: ``offset`` draws the elements at
    flat positions ``[offset, offset + prod(shape))`` of a longer draw
    (one shard's slice of a population-wide stream)."""
    shape = _shape(shape)
    hi, lo = _counters(math.prod(shape), key.device, offset)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(*lead, 1)
    k1 = key[..., 1].reshape(*lead, 1)
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return (b0 ^ b1).reshape(*lead, *shape)


def uniform(key: torch.Tensor, shape: Shape = (), minval=0.0,
            maxval=1.0, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 (bit-exact; the reference's
    ``floats * (max - min) + min`` is one fused multiply-add); ``offset``
    as in :func:`bits`."""
    b = bits(key, shape, offset)
    fb = ((b >> 9) | 0x3F800000).to(torch.int32)
    floats = fb.view(torch.float32) - 1.0
    lo, hi = f32(minval, key), f32(maxval, key)
    return torch.maximum(lo, fma(floats, hi - lo, lo))


def bernoulli(key: torch.Tensor, p: float, shape: Shape,
              offset: int = 0) -> torch.Tensor:
    """``jax.random.bernoulli`` with a scalar ``p`` (bit-exact); ``offset``
    as in :func:`bits`."""
    return uniform(key, shape, offset=offset) < f32(p, key)


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32 output and scalar bounds
    (bit-exact): two 32-bit draws folded into ``[minval, maxval)`` with
    JAX's span/multiplier arithmetic. Returns int64 values."""
    halves = split(key)
    higher = bits(halves[..., 0, :], shape)
    lower = bits(halves[..., 1, :], shape)
    span = (int(maxval) - int(minval)) & MASK
    if maxval <= minval:
        span = 1
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & MASK) % span  # uint32 wrap
    offset = (((higher % span) * multiplier) & MASK) + (lower % span)
    offset = (offset & MASK) % span
    return offset + int(minval)


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)`` with the
    reference's exact uniform ``u``; close to JAX, not bit-exact."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(key, shape, lo, 1.0)
    return f32(math.sqrt(2), key) * torch.erfinv(u)


def gumbel(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.gumbel`` (its default ``"low"`` mode) in float32:
    ``-log(-log(u))`` of the reference's exact ``u`` in ``[tiny, 1)``.
    The logs are torch's, which can differ from XLA's in the last bit;
    the order of distinct ``u`` is kept wherever neighbouring draws lie
    more than an ulp apart."""
    u = uniform(key, shape, torch.finfo(torch.float32).tiny, 1.0)
    return -torch.log(-torch.log(u))


def choice_without_replacement(key: torch.Tensor, n_inputs: int, k: int,
                               p: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, n_inputs, (k,), replace=False, p=p)``: the
    Gumbel top-k of ``gumbel(key, (n_inputs,)) + log(p)`` (``p`` float32),
    equal scores lowest index first as ``lax.top_k``. Returns int64."""
    g = gumbel(key, (n_inputs,)) + torch.log(p)
    return torch.sort(orderable_key(g), descending=True,
                      stable=True).indices[:k]


def gamma(key: torch.Tensor, a: float, shape: Shape) -> torch.Tensor:
    """Gamma(a, 1) variates in float32 on ``key``'s device (Marsaglia and
    Tsang's rejection method, with the ``U ** (1/a)`` boost below a = 1),
    from this module's streams only: attempt i draws its normals and
    uniforms from ``fold_in(key, i)`` for every element and keeps the
    first accepted one. Distributed as the reference's
    ``jax.random.gamma``, not equal to its draws."""
    shape = _shape(shape)
    boost = a < 1.0
    d = (a + 1.0 if boost else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(shape, dtype=torch.float32, device=key.device)
    done = torch.zeros(shape, dtype=torch.bool, device=key.device)
    attempt = 0
    while not bool(done.all()):
        kz, ku = split(fold_in(key, attempt))
        z = normal(kz, shape)
        u = uniform(ku, shape)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(torch.clamp_min(v, 1e-30)))
        out = torch.where(ok & ~done, d * v, out)
        done = done | ok
        attempt += 1
    if boost:
        ub = uniform(fold_in(key, -1), shape)
        out = out * ub ** (1.0 / a)
    return out


def dirichlet(key: torch.Tensor, alpha: float, shape: Shape) -> torch.Tensor:
    """Dirichlet(alpha * ones) rows over the last dimension of ``shape``,
    normalised :func:`gamma` variates (float32)."""
    g = gamma(key, alpha, shape)
    return g / torch.clamp_min(g.sum(dim=-1, keepdim=True), 1e-30)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (bit-exact): rounds of a stable
    sort of ``arange(n)`` keyed by fresh 32-bit draws. Batched over the
    leading key dimensions; returns int64 ``key.shape[:-1] + (n,)``."""
    num_rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    x = x.expand(*key.shape[:-1], n)
    for _ in range(num_rounds):
        halves = split(key)
        key, sub = halves[..., 0, :], halves[..., 1, :]
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def choice_p(key: torch.Tensor, n_inputs: int, shape: Shape,
             p: Sequence[float]) -> torch.Tensor:
    """``jax.random.choice(key, n_inputs, shape, replace=True, p=p)``:
    inverse-CDF sampling over the float32 cumulative ``p``. Returns int64."""
    p_cuml = torch.cumsum(torch.tensor(p, dtype=torch.float32,
                                       device=key.device), 0)
    r = p_cuml[-1] * (1.0 - uniform(key, shape))
    return torch.searchsorted(p_cuml, r.contiguous())
