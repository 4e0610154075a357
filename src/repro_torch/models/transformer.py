"""The unified decoder model: stage list + a loop over layers.

An architecture is compiled into a list of *stages*; each stage is either a
run of layers of one kind or a single application of the Zamba2
weight-shared attention block. The reference runs each run with
``lax.scan`` over stacked parameters; here it is a Python loop, and the
parameters of a run are a list of per-layer dicts (the converter unstacks
the reference's stacked leaves, :func:`repro_torch.convert.lm_params`).
The cache is laid out the same way. The reference's ``jax.checkpoint``
around each scan body (``remat``) is ``torch.utils.checkpoint`` around
each layer of a run.

Public API (entry points take ``device``: the CUDA card unless
``device="cpu"`` is passed, and they raise with no card and no explicit
CPU):
  init_params(seed, cfg, device=None)
  forward_logits(cfg, params, batch, device=None)   prefill -> logits
  loss_fn(cfg, params, batch, remat=True, device=None) -> (loss, metrics)
  init_cache(cfg, batch, cache_len, dtype, device=None)
  decode_step(cfg, params, batch, cache, cache_index, ring, device=None)
The vision frontend and multi-codebook heads raise. ``loss_fn`` is
differentiable by autograd on both routes: the attention, SSD and
selective-scan kernels each have a backward kernel (``kernels/ops.py``),
so olmo-1b, zamba2 and falcon train on the card.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.blocks import (block_decode, block_forward,
                                       init_block, init_block_cache)
from repro_torch.models.common import (apply_norm, cross_entropy, init_norm,
                                       normal_init)

Params = Dict[str, Any]


def _check_supported(cfg) -> None:
    if cfg.frontend == "vision":
        raise NotImplementedError(
            "the vision frontend is not ported yet (ROADMAP.md queue 1 "
            "item 16)")
    if cfg.n_codebooks > 1:
        raise NotImplementedError(
            "multi-codebook heads are not ported yet (ROADMAP.md queue 1 "
            "item 16)")


# ------------------------------------------------------------------ stages
def build_stages(cfg) -> List[Tuple[str, int]]:
    if cfg.arch_type == "hybrid":
        stages: List[Tuple[str, int]] = []
        groups, rem = divmod(cfg.n_layers, cfg.attn_every)
        for _ in range(groups):
            stages.append(("ssm", cfg.attn_every))
            stages.append(("shared_attn", 1))
        if rem:
            stages.append(("ssm", rem))
        return stages
    if cfg.arch_type == "ssm":
        return [("ssm", cfg.n_layers)]
    if cfg.n_experts:
        stages = []
        if cfg.first_k_dense:
            stages.append(("dense", cfg.first_k_dense))
        stages.append(("moe", cfg.n_layers - cfg.first_k_dense))
        return stages
    return [("dense", cfg.n_layers)]


# ------------------------------------------------------------------- init
def init_params(seed: int, cfg, device: DeviceLike = None) -> Params:
    """Random parameters from ``torch.Generator(device).manual_seed(seed)``
    (f32 master weights in ``cfg.param_dtype``). They are not the
    reference's numbers: carry those across with ``convert.lm_params``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    D = cfg.d_model
    p: Params = {"embed": normal_init(gen, (cfg.vocab_size, D), D ** -0.5,
                                      cfg.param_dtype)}
    p["stages"] = [None if kind == "shared_attn"  # weights: p["shared_attn"]
                   else [init_block(gen, cfg, kind) for _ in range(n)]
                   for kind, n in build_stages(cfg)]
    if cfg.arch_type == "hybrid":
        p["shared_attn"] = init_block(gen, cfg, "shared_attn")
    fn = init_norm(cfg, D, dev)
    if fn is not None:
        p["final_norm"] = fn
    if not cfg.tie_embeddings:
        p["lm_head"] = normal_init(gen, (D, cfg.vocab_size), D ** -0.5,
                                   cfg.param_dtype)
    return p


# ------------------------------------------------------------------ embed
def embed_tokens(cfg, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    _check_supported(cfg)
    return params["embed"][tokens.long()].to(cfg.compute_dtype)


def output_logits(cfg, params: Params, h: torch.Tensor) -> torch.Tensor:
    _check_supported(cfg)
    cd = cfg.compute_dtype
    if cfg.tie_embeddings:
        return h @ params["embed"].to(cd).T
    return h @ params["lm_head"].to(cd)


# ---------------------------------------------------------------- forward
def _layer(cfg, kind: str, use_kernel: Optional[bool], h, positions,
           layer_p):
    return block_forward(cfg, kind, layer_p, h, positions,
                         use_kernel=use_kernel)[0]


def _run_stages(cfg, params: Params, h, positions,
                use_kernel: Optional[bool] = None, remat: bool = False):
    """The layers in order. With ``remat`` each layer of a run keeps only
    its input for the backward and runs again there (the reference's
    ``jax.checkpoint`` around its scan body); the one ``shared_attn``
    call is not rematerialised, as in the reference."""
    for (kind, _), sp in zip(build_stages(cfg), params["stages"]):
        if kind == "shared_attn":
            h = _layer(cfg, kind, use_kernel, h, positions,
                       params["shared_attn"])
            continue
        body = partial(_layer, cfg, kind, use_kernel)
        for layer_p in sp:
            if remat:
                h = checkpoint(body, h, positions, layer_p,
                               use_reentrant=False)
            else:
                h = body(h, positions, layer_p)
    return h


def _embed_batch(cfg, params: Params, batch, device: torch.device):
    """Returns (h, positions)."""
    tokens = torch.as_tensor(batch["tokens"], device=device)
    h = embed_tokens(cfg, params, tokens)
    B, S = h.shape[0], h.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
    return h, positions


def forward_logits(cfg, params: Params, batch, device: DeviceLike = None,
                   use_kernel: Optional[bool] = None):
    """Prefill / eval forward: logits (B, S, V) for every position.

    ``batch["tokens"]`` (B, S) is moved to ``device``, where ``params``
    must lie. ``use_kernel`` (default: on CUDA) picks the Hopper kernels
    over the plain routes in every layer. The reference's ``remat`` is a
    training-memory knob and has no counterpart in a forward."""
    dev = resolve_device(device)
    h, positions = _embed_batch(cfg, params, batch, dev)
    h = _run_stages(cfg, params, h, positions, use_kernel)
    h = apply_norm(cfg, params, h, "final_norm")
    return output_logits(cfg, params, h)


def loss_fn(cfg, params: Params, batch, remat: bool = True,
            device: DeviceLike = None, use_kernel: Optional[bool] = None):
    """Train forward: ``(loss, {"ce", "aux"})``, f32 0-d tensors.

    ``batch``: ``tokens`` and ``labels`` (B, S), labels -100 ignored,
    moved to ``device``, where ``params`` must lie. ``loss = ce + aux``;
    ``aux`` (the MoE router's loss in the reference) is 0 for the block
    kinds ported. ``remat`` rematerialises each layer in the backward;
    ``use_kernel`` as in :func:`forward_logits`."""
    dev = resolve_device(device)
    h, positions = _embed_batch(cfg, params, batch, dev)
    h = _run_stages(cfg, params, h, positions, use_kernel, remat)
    h = apply_norm(cfg, params, h, "final_norm")
    logits = output_logits(cfg, params, h)
    ce = cross_entropy(logits, torch.as_tensor(batch["labels"], device=dev))
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return ce + aux, {"ce": ce, "aux": aux}


# ----------------------------------------------------------------- decode
def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device: DeviceLike = None) -> List[Any]:
    """One entry per stage: a list of per-layer caches for a run of layers,
    one cache dict for a ``shared_attn`` call."""
    _check_supported(cfg)
    dev = resolve_device(device)
    caches: List[Any] = []
    for kind, n in build_stages(cfg):
        if kind == "shared_attn":
            caches.append(init_block_cache(cfg, kind, batch, cache_len,
                                           dtype, dev))
        else:
            caches.append([init_block_cache(cfg, kind, batch, cache_len,
                                            dtype, dev) for _ in range(n)])
    return caches


def decode_step(cfg, params: Params, batch, cache: List[Any],
                cache_index: int, ring: bool = False,
                device: DeviceLike = None):
    """One-token decode. ``batch["tokens"]``: (B, 1). Returns
    ``(logits (B, 1, V), new cache)``; the given cache is not modified,
    as in the reference."""
    dev = resolve_device(device)
    h = embed_tokens(cfg, params, torch.as_tensor(batch["tokens"],
                                                  device=dev))
    new_caches: List[Any] = []
    for (kind, _), sp, sc in zip(build_stages(cfg), params["stages"], cache):
        if kind == "shared_attn":
            h, nc = block_decode(cfg, kind, params["shared_attn"], h, sc,
                                 cache_index, ring)
            new_caches.append(nc)
            continue
        layer_caches = []
        for layer_p, layer_c in zip(sp, sc):
            h, nc = block_decode(cfg, kind, layer_p, h, layer_c,
                                 cache_index, ring)
            layer_caches.append(nc)
        new_caches.append(layer_caches)
    h = apply_norm(cfg, params, h, "final_norm")
    return output_logits(cfg, params, h), new_caches
