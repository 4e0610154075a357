"""Shared building blocks: norms, activations, initializers, FFN, loss.

The port's ``repro/models/common.py``. The reference's
``models/sharding_ctx.py`` has no counterpart: on one device its
``weight_cast(w, dtype)`` is ``w.astype(dtype)``, written ``w.to(dtype)``
here at each use site, and ``precast_params`` and ``constrain`` do nothing
without a mesh (``sharding_ctx.py:98-132``).

Random numbers come from an explicit ``torch.Generator``; the port's
initial weights therefore differ from the reference's, and the tests carry
the reference's weights across with :func:`repro_torch.convert.lm_params`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def normal_init(gen: torch.Generator, shape, scale: float,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in f32 from ``gen`` (on ``gen``'s device
    unless ``device`` says otherwise), cast to ``dtype``."""
    device = gen.device if device is None else device
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (scale * x).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> torch.Tensor:
    """Fan-in init for a ``(d_in, d_out)`` matmul weight (``x @ W``)."""
    return normal_init(gen, (d_in, d_out), d_in ** -0.5, dtype)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    if weight is not None:
        x = x * weight.float()
    return x.to(dtype)


def np_layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: no scale, no bias. [arXiv:2402.00838]"""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dtype)


def apply_norm(cfg, params: Params, x: torch.Tensor, name: str) -> torch.Tensor:
    if cfg.norm == "np_layernorm":
        return np_layer_norm(x)
    return rms_norm(x, params[name])


def init_norm(cfg, d: int, device=None) -> Optional[torch.Tensor]:
    if cfg.norm == "np_layernorm":
        return None  # non-parametric; apply_norm ignores params
    return torch.ones((d,), dtype=torch.float32, device=device)


def swiglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    return F.silu(x_gate) * x_up


def ffn_init(gen: torch.Generator, cfg, d_model: int, d_ff: int) -> Params:
    p = {
        "w_up": dense_init(gen, d_model, d_ff, cfg.param_dtype),
        "w_down": dense_init(gen, d_ff, d_model, cfg.param_dtype),
    }
    if cfg.act == "swiglu":
        p["w_gate"] = dense_init(gen, d_model, d_ff, cfg.param_dtype)
    return p


def ffn_apply(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    cd = cfg.compute_dtype
    up = x @ p["w_up"].to(cd)
    if cfg.act == "swiglu":
        h = swiglu(x @ p["w_gate"].to(cd), up)
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ p["w_down"].to(cd)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -100) -> torch.Tensor:
    """Mean token cross-entropy; labels == ignore_index are masked out."""
    logits = logits.float()
    mask = labels != ignore_index
    labels_safe = torch.where(mask, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)
