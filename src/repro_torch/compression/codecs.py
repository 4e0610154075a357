"""Model-update compression for upload-energy reduction, in PyTorch.

Codecs return BOTH the decompressed (approximate) delta used for
aggregation and the wire-size ratio the energy simulation charges; each
codec's ratio formula lives in ``_RATIOS`` and :func:`compression_ratio`
reads the same formula.

Codecs:
  none    identity (ratio 1.0)
  int8    per-tensor absmax int8 quantization (ratio 0.25)
  topk    magnitude top-k sparsification, k = sparsity*n
          (ratio sparsity * 2: values + indices)

They act on one client's delta tree; the training loop maps them over the
cohort with ``torch.func.vmap``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch
from torch.utils._pytree import tree_map

PyTree = Any


@dataclass
class CompressionResult:
    delta: PyTree          # decompressed (approximate) update
    wire_ratio: float      # uploaded bytes / raw float32 bytes


_RATIOS: Dict[str, Callable[..., float]] = {
    "none": lambda: 1.0,
    "int8": lambda: 0.25,
    "topk": lambda sparsity=0.05: sparsity * 2.0,
}


def _identity(delta: PyTree) -> CompressionResult:
    return CompressionResult(delta, _RATIOS["none"]())


def _int8(delta: PyTree) -> CompressionResult:
    def q(x):
        if x.ndim == 0:
            return x
        scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
        return torch.round(x / scale).to(torch.int8).to(x.dtype) * scale

    return CompressionResult(tree_map(q, delta), _RATIOS["int8"]())


def _topk(delta: PyTree, sparsity: float = 0.05) -> CompressionResult:
    def s(x):
        if x.ndim == 0 or x.numel() < 32:
            return x
        flat = x.reshape(-1)
        k = max(1, int(sparsity * flat.numel()))
        thresh = torch.topk(flat.abs(), k).values[-1]
        return torch.where(x.abs() >= thresh, x, torch.zeros_like(x))

    return CompressionResult(tree_map(s, delta),
                             _RATIOS["topk"](sparsity=sparsity))


CODECS: Dict[str, Callable[..., CompressionResult]] = {
    "none": _identity,
    "int8": _int8,
    "topk": _topk,
}


def compress_delta(name: str, delta: PyTree, **params) -> CompressionResult:
    """Compress+decompress ``delta`` with codec ``name``."""
    if name not in CODECS:
        raise KeyError(f"unknown codec {name!r}; known: {sorted(CODECS)}")
    return CODECS[name](delta, **params)


def compression_ratio(name: str, **params) -> float:
    """Wire ratio codec ``name`` stamps on its results for ``params``."""
    if name not in _RATIOS:
        raise KeyError(f"unknown codec {name!r}; known: {sorted(_RATIOS)}")
    return _RATIOS[name](**params)


def wire_bytes(model_bytes: float, name: str, **params) -> float:
    """Bytes a codec ``name``-encoded update puts on the wire."""
    return float(model_bytes) * compression_ratio(name, **params)
