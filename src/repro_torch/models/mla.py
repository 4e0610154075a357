"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3). [arXiv:2405.04434]

The port of ``repro/models/mla.py``. Train and prefill use the
decompressed form: the latent ``c_kv`` is expanded into per-head keys and
values, and the heads attend through
:func:`repro_torch.models.attention.multihead_attention`, so on a CUDA
tensor they reach the attention kernel, with a q.k width of ``qk_nope +
qk_rope`` (96 for minicpm3-4b) and a v width of ``v_head_dim`` (64).
Decode uses the absorbed form in plain torch, as the reference: the query
is projected into the latent space and attends directly against the
compressed ``(c_kv, k_rope)`` cache, MLA's cache saving; it reaches no
kernel in either package.

Decode is functional, as the reference's ``dynamic_update_slice``: it
returns a new cache with the new slot written and leaves the given one as
it was.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.attention import NEG_INF, multihead_attention
from repro_torch.models.common import dense_init, rms_norm
from repro_torch.models.rope import apply_rope

Params = Dict[str, torch.Tensor]


def init_mla(gen: torch.Generator, cfg) -> Params:
    """The reference's leaves and shapes: with ``q_lora_rank`` the query
    goes through ``wdq``, ``q_norm`` and ``wuq``, else through ``wq``."""
    H = cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    p: Params = {}
    if cfg.q_lora_rank:
        p["wdq"] = dense_init(gen, cfg.d_model, cfg.q_lora_rank,
                              cfg.param_dtype)
        p["q_norm"] = torch.ones((cfg.q_lora_rank,), dtype=torch.float32,
                                 device=gen.device)
        p["wuq"] = dense_init(gen, cfg.q_lora_rank, H * qk, cfg.param_dtype)
    else:
        p["wq"] = dense_init(gen, cfg.d_model, H * qk, cfg.param_dtype)
    p["wdkv"] = dense_init(gen, cfg.d_model, cfg.kv_lora_rank,
                           cfg.param_dtype)
    p["kv_norm"] = torch.ones((cfg.kv_lora_rank,), dtype=torch.float32,
                              device=gen.device)
    p["wkr"] = dense_init(gen, cfg.d_model, cfg.qk_rope_dim, cfg.param_dtype)
    p["wuk"] = dense_init(gen, cfg.kv_lora_rank, H * cfg.qk_nope_dim,
                          cfg.param_dtype)
    p["wuv"] = dense_init(gen, cfg.kv_lora_rank, H * cfg.v_head_dim,
                          cfg.param_dtype)
    p["wo"] = dense_init(gen, H * cfg.v_head_dim, cfg.d_model,
                         cfg.param_dtype)
    return p


def _queries(cfg, p: Params, x):
    """``(q_nope, q_rope)``, each ``(B, S, H, width)``, before RoPE."""
    B, S, _ = x.shape
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    cd = cfg.compute_dtype
    if cfg.q_lora_rank:
        cq = rms_norm(x @ p["wdq"].to(cd), p["q_norm"])
        q = cq @ p["wuq"].to(cd)
    else:
        q = x @ p["wq"].to(cd)
    q = q.reshape(B, S, cfg.n_heads, qk)
    return torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)


def mla_forward(cfg, p: Params, x, positions, return_kv: bool = False,
                use_kernel: Optional[bool] = None):
    """Decompressed-form self-attention (train / prefill). Returns ``(out,
    (c_kv, k_rope) or None)``. ``use_kernel`` as in
    :func:`~repro_torch.models.attention.multihead_attention`."""
    B, S, _ = x.shape
    H = cfg.n_heads
    cd = cfg.compute_dtype
    q_nope, q_rope = _queries(cfg, p, x)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv = rms_norm(x @ p["wdkv"].to(cd), p["kv_norm"])          # (B,S,r)
    k_rope = apply_rope(x @ p["wkr"].to(cd), positions, cfg.rope_theta)
    k_nope = (c_kv @ p["wuk"].to(cd)).reshape(B, S, H, cfg.qk_nope_dim)
    v = (c_kv @ p["wuv"].to(cd)).reshape(B, S, H, cfg.v_head_dim)

    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, cfg.qk_rope_dim)], dim=-1)
    out = multihead_attention(q, k, v, causal=True, use_kernel=use_kernel)
    out = out.reshape(B, S, H * cfg.v_head_dim) @ p["wo"].to(cd)
    return out, ((c_kv, k_rope) if return_kv else None)


def init_mla_cache(cfg, batch: int, cache_len: int, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    return {"c_kv": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, cache_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}


def mla_decode(cfg, p: Params, x, cache: Dict[str, torch.Tensor],
               cache_index: int, ring: bool):
    """Absorbed-form one-token decode against the latent cache. x:
    ``(B, 1, D)``; cache ``c_kv`` ``(B, L, r)``, ``k_rope`` ``(B, L,
    qk_rope)``. ``cache_index`` and ``ring`` as in
    :func:`~repro_torch.models.attention.gqa_decode`. Returns ``(out, new
    cache)``; the given cache is not modified."""
    B = x.shape[0]
    H = cfg.n_heads
    r = cfg.kv_lora_rank
    cd = cfg.compute_dtype
    L = cache["c_kv"].shape[1]
    pos = torch.full((B, 1), int(cache_index), dtype=torch.int32,
                     device=x.device)

    q_nope, q_rope = _queries(cfg, p, x)                          # (B,1,H,*)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)

    c_new = rms_norm(x @ p["wdkv"].to(cd), p["kv_norm"])          # (B,1,r)
    kr_new = apply_rope(x @ p["wkr"].to(cd), pos, cfg.rope_theta)

    slot = int(cache_index) % L
    c_kv, k_rope = cache["c_kv"].clone(), cache["k_rope"].clone()
    c_kv[:, slot] = c_new[:, 0].to(c_kv.dtype)
    k_rope[:, slot] = kr_new[:, 0].to(k_rope.dtype)

    # absorb W_UK into the query: q_lat[h] = q_nope[h] @ W_UK[:, h, :].T
    wuk = p["wuk"].to(cd).reshape(r, H, cfg.qk_nope_dim)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wuk)      # (B,H,r)

    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    scores = (torch.einsum("bhr,blr->bhl", q_lat, c_kv.to(cd))
              + torch.einsum("bhd,bld->bhl", q_rope[:, 0], k_rope.to(cd)))
    scores = scores.float() * scale
    if not ring:
        valid = torch.arange(L, device=x.device) <= int(cache_index)
        scores = torch.where(valid, scores,
                             torch.tensor(NEG_INF, dtype=scores.dtype,
                                          device=scores.device))
    w = torch.softmax(scores, dim=-1).to(cd)

    ctx_lat = torch.einsum("bhl,blr->bhr", w, c_kv.to(cd))       # (B,H,r)
    wuv = p["wuv"].to(cd).reshape(r, H, cfg.v_head_dim)
    ctx = torch.einsum("bhr,rhd->bhd", ctx_lat, wuv)             # (B,H,vd)
    out = ctx.reshape(B, 1, H * cfg.v_head_dim) @ p["wo"].to(cd)
    return out, {"c_kv": c_kv, "k_rope": k_rope}
