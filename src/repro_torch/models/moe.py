"""Mixture-of-experts FFN: top-k routing with a per-sequence capacity.

The port's ``repro/models/moe.py``. The router's logits are f32
(``x.float() @ router``); each token takes the ``experts_per_token``
experts of highest softmax probability (ties lowest index first, as
``lax.top_k``: a stable descending sort) and renormalises their gates
over the top k. Each batch row has ``C = expert_capacity(cfg, S)`` slots
an expert. Slots are taken rank-major: every token's first choice before
any second choice, and within a rank in sequence order; a choice whose
slot is ``>= C`` is dropped. The aux loss is the reference's Switch-style
``E * sum(f / K * P)``: ``f`` the share of the choices each expert got
(no gradient), ``P`` its mean probability. Only the gates carry a
gradient; the slots are integers.

The reference dispatches with (B, S, E, C) one-hot tensors and einsums.
Here the experts' (E, B * C, D) input blocks are a gather by slot index:
the reference's dispatch sums one 1.0 term per filled slot and zeros, so
the blocks are the same numbers. The experts are batched matmuls over E,
their weights cast to ``compute_dtype`` at use, as ``common.ffn_apply``
does. Each token then gathers its kept slots' outputs and sums them
weighted by its gates cast to ``compute_dtype`` (the reference's
``combine.astype(x.dtype)``). Nothing is added by atomics, so the forward
is deterministic on the card. Shared experts (DeepSeek-V2, Llama-4) are a
dense FFN of width ``n_shared_experts * moe_d_ff`` on every token.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (dense_init, ffn_apply, ffn_init,
                                       normal_init)

Params = Dict[str, torch.Tensor]


class Routing(NamedTuple):
    """Each token's choices, (B, S, K) each, rank r at ``[..., r]``."""
    experts: torch.Tensor     # int64 expert ids, best first
    slots: torch.Tensor       # int64 slot in the expert's row of C
    keep: torch.Tensor        # bool: slot < C
    gates: torch.Tensor       # f32, renormalised over the top k
    aux: torch.Tensor         # f32 0-d, before ``router_aux_weight``


def init_moe(gen: torch.Generator, cfg) -> Params:
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    p: Params = {
        "router": dense_init(gen, D, E, torch.float32),
        "w_gate": normal_init(gen, (E, D, Fd), D ** -0.5, cfg.param_dtype),
        "w_up": normal_init(gen, (E, D, Fd), D ** -0.5, cfg.param_dtype),
        "w_down": normal_init(gen, (E, Fd, D), Fd ** -0.5, cfg.param_dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = ffn_init(gen, cfg, D, cfg.n_shared_experts * Fd)
    return p


def expert_capacity(cfg, seq: int) -> int:
    """Slots an expert has in one batch row of ``seq`` tokens: at least 4,
    rounded up to a multiple of 4."""
    c = int(cfg.experts_per_token * seq * cfg.capacity_factor / cfg.n_experts)
    return max(4, -(-c // 4) * 4)


def route(cfg, router_w: torch.Tensor, x: torch.Tensor) -> Routing:
    """The routing of ``x`` (B, S, D) by ``router_w`` (D, E)."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    C = expert_capacity(cfg, S)
    probs = torch.softmax(x.float() @ router_w, dim=-1)           # (B,S,E)
    experts = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[..., :K]             # (B,S,K)
    gates = torch.gather(probs, -1, experts)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # rank-major slots: a running count over (rank, position) per expert
    by_rank = experts.transpose(1, 2)                              # (B,K,S)
    onehot = F.one_hot(by_rank, E)                                 # (B,K,S,E)
    count = onehot.reshape(B, K * S, E).cumsum(1).reshape(B, K, S, E)
    slots = (torch.gather(count, -1, by_rank[..., None])[..., 0] - 1
             ).transpose(1, 2)                                     # (B,S,K)
    f = onehot.sum(dim=(0, 1, 2)).float() / (B * S)                # (E,)
    P = probs.mean(dim=(0, 1))
    aux = E * torch.sum(f / K * P)
    return Routing(experts, slots, slots < C, gates, aux)


def moe_apply(cfg, p: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss * router_aux_weight)."""
    B, S, D = x.shape
    E, cd = cfg.n_experts, cfg.compute_dtype
    C = expert_capacity(cfg, S)
    r = route(cfg, p["router"], x)
    n_slots = E * B * C
    # the row of the (E, B * C) blocks each choice fills; a dropped
    # choice points at the extra zero row past them
    b = torch.arange(B, device=x.device)[:, None, None]
    slot = torch.where(r.keep, (r.experts * B + b) * C + r.slots, n_slots)
    token = (b * S + torch.arange(S, device=x.device)[None, :, None]
             ).expand_as(slot)
    # the token in each slot: kept choices fill distinct slots, each
    # dropped one a place of its own past them, so no index repeats;
    # empty slots read the zero row past the B * S tokens
    dump = n_slots + torch.arange(slot.numel(), device=x.device)
    src = torch.full((n_slots + slot.numel(),), B * S, dtype=torch.int64,
                     device=x.device)
    src.scatter_(0, torch.where(r.keep, slot, dump.view_as(slot)).reshape(-1),
                 token.reshape(-1))
    xs = torch.cat([x.reshape(B * S, D), x.new_zeros(1, D)])
    xin = xs[src[:n_slots]].view(E, B * C, D)
    h = F.silu(torch.bmm(xin, p["w_gate"].to(cd))) * torch.bmm(
        xin, p["w_up"].to(cd))
    eout = torch.bmm(h, p["w_down"].to(cd)).view(n_slots, D)
    rows = torch.cat([eout, eout.new_zeros(1, D)])[slot]         # (B,S,K,D)
    w = torch.where(r.keep, r.gates, 0.0).to(cd)
    out = (w[..., None, :] @ rows)[..., 0, :]
    if cfg.n_shared_experts:
        out = out + ffn_apply(cfg, p["shared"], x)
    return out, r.aux * cfg.router_aux_weight
