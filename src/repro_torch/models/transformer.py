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
All ten of the reference's archs run: the dense GQA and MLA stacks
(olmo-1b, phi3-mini-3.8b, phi4-mini-3.8b, minicpm3-4b), the SSM ones
(zamba2-1.2b, falcon-mamba-7b), the mixture-of-experts ones
(llama4-scout-17b-a16e; deepseek-v2-236b, MLA with a leading dense layer),
the vision frontend (internvl2-2b: the batch's precomputed
``vision_embeds`` (B, P, D) go before the text, positions run over P + T,
and the loss ignores the P patch positions) and the multi-codebook heads
(musicgen-large: tokens (B, S, ncb), their ``(ncb, V, D)`` embeddings
summed on the way in, one ``(D, V)`` head per codebook on the way out,
logits (B, S, ncb, V)). ``loss_fn`` is differentiable by autograd on both
routes and adds the MoE routers' aux loss to the cross-entropy: the
attention, SSD and selective-scan kernels each have a backward kernel
(``kernels/ops.py``), built for every attention width pair,
deepseek-v2-236b's (192, 128) included.
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
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    D = cfg.d_model
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    p: Params = {"embed": normal_init(gen, books + (cfg.vocab_size, D),
                                      D ** -0.5, cfg.param_dtype)}
    p["stages"] = [None if kind == "shared_attn"  # weights: p["shared_attn"]
                   else [init_block(gen, cfg, kind) for _ in range(n)]
                   for kind, n in build_stages(cfg)]
    if cfg.arch_type == "hybrid":
        p["shared_attn"] = init_block(gen, cfg, "shared_attn")
    fn = init_norm(cfg, D, dev)
    if fn is not None:
        p["final_norm"] = fn
    if not cfg.tie_embeddings:
        p["lm_head"] = normal_init(gen, books + (D, cfg.vocab_size),
                                   D ** -0.5, cfg.param_dtype)
    return p


# ------------------------------------------------------------------ embed
def embed_tokens(cfg, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Tokens (B, S), or (B, S, ncb) with codebooks, whose lookups are
    summed in the embedding's dtype in codebook order (the reference's
    ``sum``), then cast to the compute dtype."""
    tokens = tokens.long()
    if cfg.n_codebooks > 1:
        h = params["embed"][0][tokens[..., 0]]
        for c in range(1, cfg.n_codebooks):
            h = h + params["embed"][c][tokens[..., c]]
        return h.to(cfg.compute_dtype)
    return params["embed"][tokens].to(cfg.compute_dtype)


def output_logits(cfg, params: Params, h: torch.Tensor) -> torch.Tensor:
    """Logits (B, S, V), or (B, S, ncb, V) with codebooks: one product a
    codebook against its head (or, tied, its embedding)."""
    cd = cfg.compute_dtype
    if cfg.n_codebooks > 1:
        if cfg.tie_embeddings:
            return torch.einsum("bsd,cvd->bscv", h, params["embed"].to(cd))
        return torch.einsum("bsd,cdv->bscv", h, params["lm_head"].to(cd))
    if cfg.tie_embeddings:
        return h @ params["embed"].to(cd).T
    return h @ params["lm_head"].to(cd)


# ---------------------------------------------------------------- forward
def _layer(cfg, kind: str, use_kernel: Optional[bool], h, positions,
           layer_p):
    """``(h, aux)`` of one layer."""
    return block_forward(cfg, kind, layer_p, h, positions,
                         use_kernel=use_kernel)[:2]


def _run_stages(cfg, params: Params, h, positions,
                use_kernel: Optional[bool] = None, remat: bool = False):
    """The layers in order: ``(h, aux)``, aux the f32 sum of the layers'
    router losses. With ``remat`` each layer of a run keeps only its input
    for the backward and runs again there (the reference's
    ``jax.checkpoint`` around its scan body), its router on the same
    saved input, so the recompute routes the tokens as the forward did;
    the one ``shared_attn`` call is not rematerialised, as in the
    reference."""
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for (kind, _), sp in zip(build_stages(cfg), params["stages"]):
        if kind == "shared_attn":
            h, aux = _layer(cfg, kind, use_kernel, h, positions,
                            params["shared_attn"])
            aux_total = aux_total + aux
            continue
        body = partial(_layer, cfg, kind, use_kernel)
        for layer_p in sp:
            if remat:
                h, aux = checkpoint(body, h, positions, layer_p,
                                    use_reentrant=False)
            else:
                h, aux = body(h, positions, layer_p)
            aux_total = aux_total + aux
    return h, aux_total


def _embed_batch(cfg, params: Params, batch, device: torch.device):
    """Returns (h, positions); with the vision frontend the batch's
    ``vision_embeds`` (B, P, D), cast to the compute dtype, go before the
    text, and the positions run over P + T."""
    tokens = torch.as_tensor(batch["tokens"], device=device)
    h = embed_tokens(cfg, params, tokens)
    if cfg.frontend == "vision":
        ve = torch.as_tensor(batch["vision_embeds"], device=device)
        h = torch.cat([ve.to(cfg.compute_dtype), h], dim=1)
    B, S = h.shape[0], h.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
    return h, positions


def forward_logits(cfg, params: Params, batch, device: DeviceLike = None,
                   use_kernel: Optional[bool] = None):
    """Prefill / eval forward: logits (B, S, V) for every position
    ((B, S, ncb, V) with codebooks; S counts the patches first with the
    vision frontend).

    ``batch["tokens"]`` (B, T) or (B, T, ncb), and ``vision_embeds`` (B,
    P, D) with the vision frontend, are moved to ``device``, where
    ``params`` must lie. ``use_kernel`` (default: on CUDA) picks the Hopper kernels
    over the plain routes in every layer. The reference's ``remat`` is a
    training-memory knob and has no counterpart in a forward."""
    dev = resolve_device(device)
    h, positions = _embed_batch(cfg, params, batch, dev)
    h, _ = _run_stages(cfg, params, h, positions, use_kernel)
    h = apply_norm(cfg, params, h, "final_norm")
    return output_logits(cfg, params, h)


def loss_fn(cfg, params: Params, batch, remat: bool = True,
            device: DeviceLike = None, use_kernel: Optional[bool] = None):
    """Train forward: ``(loss, {"ce", "aux"})``, f32 0-d tensors.

    ``batch``: ``tokens`` and ``labels`` (B, T) or (B, T, ncb), labels
    -100 ignored, and ``vision_embeds`` with the vision frontend, whose
    ``cfg.n_patches`` positions the labels are padded over with -100;
    moved to ``device``, where ``params`` must lie. ``loss = ce + aux``;
    ``aux`` is the sum of the MoE layers' router losses (0 without MoE
    layers). ``remat`` rematerialises each layer in the backward;
    ``use_kernel`` as in :func:`forward_logits`."""
    dev = resolve_device(device)
    h, positions = _embed_batch(cfg, params, batch, dev)
    h, aux = _run_stages(cfg, params, h, positions, use_kernel, remat)
    h = apply_norm(cfg, params, h, "final_norm")
    logits = output_logits(cfg, params, h)
    labels = torch.as_tensor(batch["labels"], device=dev)
    if cfg.frontend == "vision":
        pad = labels.new_full((labels.shape[0], cfg.n_patches)
                              + labels.shape[2:], -100)
        labels = torch.cat([pad, labels], dim=1)
    ce = cross_entropy(logits, labels)
    return ce + aux, {"ce": ce, "aux": aux}


# ----------------------------------------------------------------- decode
def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device: DeviceLike = None) -> List[Any]:
    """One entry per stage: a list of per-layer caches for a run of layers,
    one cache dict for a ``shared_attn`` call."""
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
    """One-token decode. ``batch["tokens"]``: (B, 1), or (B, 1, ncb) with
    codebooks. Returns ``(logits (B, 1, V) or (B, 1, ncb, V), new
    cache)``; the given cache is not modified, as in the reference. The
    vision frontend decodes text tokens only: no patch block enters the
    cache (the reference's serving replays text tokens alone)."""
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
