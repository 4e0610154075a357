"""GQA / MHA attention: causal train/prefill path + KV-cache decode.

On a CUDA tensor the prefill path runs the Hopper kernel
(:func:`repro_torch.kernels.ops.flash_attention`, the port of the
reference's Pallas ``flash_attention``). Elsewhere it runs the reference's
pure query-chunked form (``Q_CHUNK`` query rows against the full K/V per
step, ``S <= Q_CHUNK`` in one chunk). ``use_kernel`` overrides the choice
by device, so the plain route can also run on the card.

The two routes compute the same function but round differently in bf16:
the plain route, like the reference, computes the scores in the compute
dtype and casts the softmax weights to it before the product with v; the
kernel keeps the scores, softmax and accumulator in f32 (in bf16 it rounds
the weights only as the operand of the product with v), so the routes
agree at bf16 level, not bitwise.

Decode is functional, as the reference's ``dynamic_update_slice``: it
returns new K/V tensors with the new slot written and leaves the cache it
was given as it was.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import dense_init
from repro_torch.models.rope import apply_rope

Params = Dict[str, torch.Tensor]

Q_CHUNK = 512
NEG_INF = -1e30   # the reference's mask value


def init_gqa(gen: torch.Generator, cfg) -> Params:
    hd = cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, cfg.param_dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, cfg.param_dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, cfg.param_dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, cfg.param_dtype),
    }


def _attn_chunk(qb, k, v, row0: int, causal: bool):
    """qb: (B,Qb,KH,G,hd); k,v: (B,S,KH,hd); row0: first query position."""
    hd = qb.shape[-1]
    scores = torch.einsum("bqkgd,bskd->bkgqs", qb, k).float() * hd ** -0.5
    if causal:
        rows = row0 + torch.arange(qb.shape[1], device=qb.device)
        cols = torch.arange(k.shape[1], device=qb.device)
        mask = cols[None, :] <= rows[:, None]                 # (Qb, S)
        scores = torch.where(mask, scores,
                             torch.tensor(NEG_INF, dtype=scores.dtype,
                                          device=scores.device))
    w = torch.softmax(scores, dim=-1).to(qb.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", w, v)


def multihead_attention(q, k, v, *, causal: bool = True,
                        q_chunk: int = Q_CHUNK,
                        use_kernel: Optional[bool] = None):
    """q: (B,S,H,hd); k: (B,S,KH,hd); v: (B,S,KH,vd) with H % KH == 0.
    Returns (B,S,H,vd). The scale is hd**-0.5 (q's width); v's width vd
    differs from hd under MLA (``models/mla.py``).

    ``use_kernel`` (default: whether q is on CUDA) picks the Hopper kernel
    over the plain query-chunked route."""
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel:
        return ops.flash_attention(q, k, v, causal=causal)
    B, S, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    vd = v.shape[-1]
    qg = q.reshape(B, S, KH, G, hd)
    if S <= q_chunk:
        return _attn_chunk(qg, k, v, 0, causal).reshape(B, S, H, vd)
    if S % q_chunk:
        raise ValueError(f"S={S} must be a multiple of q_chunk={q_chunk}")
    outs = [_attn_chunk(qg[:, r:r + q_chunk], k, v, r, causal)
            for r in range(0, S, q_chunk)]
    return torch.cat(outs, dim=1).reshape(B, S, H, vd)


def gqa_forward(cfg, p: Params, x, positions, return_kv: bool = False,
                use_kernel: Optional[bool] = None):
    """Self-attention over a full sequence (train / prefill)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    cd = cfg.compute_dtype
    q = (x @ p["wq"].to(cd)).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"].to(cd)).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"].to(cd)).reshape(B, S, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = multihead_attention(q, k, v, causal=True, use_kernel=use_kernel)
    out = out.reshape(B, S, cfg.n_heads * hd) @ p["wo"].to(cd)
    return out, ((k, v) if return_kv else None)


def init_gqa_cache(cfg, batch: int, cache_len: int, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    hd = cfg.resolved_head_dim
    shape = (batch, cache_len, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(cfg, p: Params, x, cache: Dict[str, torch.Tensor],
               cache_index: int, ring: bool):
    """One-token decode. x: (B,1,D); cache k/v: (B,L,KH,hd).

    ``cache_index`` is the absolute position of the new token. With
    ``ring=True`` the cache is a sliding-window ring buffer (all slots
    valid, RoPE applied at write time); otherwise slot j holds position j
    and slots > cache_index are masked. Returns ``(out, new cache)``; the
    given cache is not modified."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    cd = cfg.compute_dtype
    L = cache["k"].shape[1]
    q = (x @ p["wq"].to(cd)).reshape(B, 1, cfg.n_heads, hd)
    k = (x @ p["wk"].to(cd)).reshape(B, 1, cfg.n_kv_heads, hd)
    v = (x @ p["wv"].to(cd)).reshape(B, 1, cfg.n_kv_heads, hd)
    pos = torch.full((B, 1), int(cache_index), dtype=torch.int32,
                     device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)

    slot = int(cache_index) % L
    ck, cv = cache["k"].clone(), cache["v"].clone()
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)

    KH = cfg.n_kv_heads
    G = cfg.n_heads // KH
    qg = q.reshape(B, KH, G, hd)
    scores = torch.einsum("bkgd,blkd->bkgl", qg, ck.to(cd)).float()
    scores = scores * hd ** -0.5
    if not ring:
        valid = torch.arange(L, device=x.device) <= int(cache_index)
        scores = torch.where(valid, scores,
                             torch.tensor(NEG_INF, dtype=scores.dtype,
                                          device=scores.device))
    w = torch.softmax(scores, dim=-1).to(cd)
    out = torch.einsum("bkgl,blkd->bkgd", w, cv.to(cd))
    out = out.reshape(B, 1, cfg.n_heads * hd) @ p["wo"].to(cd)
    return out, {"k": ck, "v": cv}
