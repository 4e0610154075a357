"""Per-layer blocks: init / forward / decode, dispatched by block kind.

Block kinds, all four of the reference's:
  dense       attention (GQA, or MLA by ``cfg.attn_kind``) + dense FFN
  moe         attention + the mixture-of-experts FFN (``models/moe.py``;
              its forward returns the router's aux loss)
  ssm         Mamba1 or Mamba2, by ``cfg.ssm_variant``
  shared_attn the Zamba2 weight-shared attention+MLP block (the same code
              as ``dense``; its one weight set is reused at every call)
``use_kernel`` reaches every block's prefill (GQA, MLA, Mamba1 and Mamba2
alike).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba, mla, moe
from repro_torch.models.common import apply_norm, ffn_apply, ffn_init, init_norm

Params = Dict[str, Any]


def _check_kind(cfg, kind: str) -> None:
    if kind not in ("dense", "moe", "shared_attn", "ssm"):
        raise ValueError(kind)


# ------------------------------------------------------------------ init
def init_block(gen: torch.Generator, cfg, kind: str) -> Params:
    _check_kind(cfg, kind)
    p: Params = {}
    if kind == "ssm":
        n = init_norm(cfg, cfg.d_model, gen.device)
        if n is not None:
            p["norm"] = n
        if cfg.ssm_variant == "mamba1":
            p["ssm"] = mamba.init_mamba1(gen, cfg)
        else:
            p["ssm"] = mamba.init_mamba2(gen, cfg)
        return p
    p["attn"] = (mla.init_mla(gen, cfg) if cfg.attn_kind == "mla"
                 else attn.init_gqa(gen, cfg))
    n = init_norm(cfg, cfg.d_model, gen.device)
    if n is not None:
        p["norm_attn"] = n
        p["norm_ffn"] = init_norm(cfg, cfg.d_model, gen.device)
    p["ffn"] = (moe.init_moe(gen, cfg) if kind == "moe"
                else ffn_init(gen, cfg, cfg.d_model, cfg.d_ff))
    return p


# --------------------------------------------------------------- forward
def block_forward(cfg, kind: str, p: Params, x, positions,
                  want_kv: bool = False, use_kernel: Optional[bool] = None):
    """Returns (x_out, aux_loss, kv_or_None): the MoE router's aux loss
    (f32 0-d, already weighted by ``router_aux_weight``), 0 for the other
    kinds."""
    _check_kind(cfg, kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "ssm":
        h = apply_norm(cfg, p, x, "norm")
        if cfg.ssm_variant == "mamba1":
            return x + mamba.mamba1_forward(cfg, p["ssm"], h,
                                            use_kernel=use_kernel), aux, None
        return x + mamba.mamba2_forward(cfg, p["ssm"], h,
                                        use_kernel=use_kernel), aux, None

    h = apply_norm(cfg, p, x, "norm_attn")
    forward = mla.mla_forward if cfg.attn_kind == "mla" else attn.gqa_forward
    a, kv = forward(cfg, p["attn"], h, positions, return_kv=want_kv,
                    use_kernel=use_kernel)
    x = x + a
    h = apply_norm(cfg, p, x, "norm_ffn")
    if kind == "moe":
        f, aux = moe.moe_apply(cfg, p["ffn"], h)
    else:
        f = ffn_apply(cfg, p["ffn"], h)
    return x + f, aux, kv


# ---------------------------------------------------------------- decode
def init_block_cache(cfg, kind: str, batch: int, cache_len: int, dtype,
                     device=None):
    _check_kind(cfg, kind)
    if kind == "ssm":
        if cfg.ssm_variant == "mamba1":
            return mamba.init_mamba1_cache(cfg, batch, dtype, device)
        return mamba.init_mamba2_cache(cfg, batch, dtype, device)
    if cfg.attn_kind == "mla":
        return mla.init_mla_cache(cfg, batch, cache_len, dtype, device)
    return attn.init_gqa_cache(cfg, batch, cache_len, dtype, device)


def block_decode(cfg, kind: str, p: Params, x, cache, cache_index: int,
                 ring: bool):
    """Returns (x_out, new_cache). x: (B,1,D)."""
    _check_kind(cfg, kind)
    if kind == "ssm":
        h = apply_norm(cfg, p, x, "norm")
        if cfg.ssm_variant == "mamba1":
            out, new_cache = mamba.mamba1_decode(cfg, p["ssm"], h, cache)
        else:
            out, new_cache = mamba.mamba2_decode(cfg, p["ssm"], h, cache)
        return x + out, new_cache

    h = apply_norm(cfg, p, x, "norm_attn")
    decode = mla.mla_decode if cfg.attn_kind == "mla" else attn.gqa_decode
    a, new_cache = decode(cfg, p["attn"], h, cache, cache_index, ring)
    x = x + a
    h = apply_norm(cfg, p, x, "norm_ffn")
    f = (moe.moe_apply(cfg, p["ffn"], h)[0] if kind == "moe"
         else ffn_apply(cfg, p["ffn"], h))
    return x + f, new_cache
