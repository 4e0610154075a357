"""Plain PyTorch versions of the port's kernels (the correctness ground
truth, and the path a wrapper takes for tensors on the CPU).

``flash_attention``, ``ssd_chunk`` and ``selective_scan`` are the
reference's oracles (``repro/kernels/ref.py``: ``flash_attention_ref``,
``ssd_chunk_ref``, ``selective_scan_ref``) with their casts, taken to the
model's layouts. ``flash_attention_fwd_lse`` and ``flash_attention_bwd``
are the plain versions of the attention kernel's forward with its saved
log-sum-exp and of its backward kernel, which has no Pallas counterpart
(the reference differentiates its pure-jnp attention)."""
from __future__ import annotations

import torch

from repro_torch.numerics import f32, fma, orderable_key

SENTINEL = -3e38          # masked-entry score: below any real reward, > -inf
MODES = ("eafl", "oort", "eafl-epj")


def reward_score(a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor, *,
                 f: float, ucb=None, mode: str = "eafl") -> torch.Tensor:
    """The fused selection score of ``kernels/topk_select``: the mix of
    ``mode``, times ``(1 + ucb)``, and ``SENTINEL`` outside ``valid``.
    ``eafl`` is ``f * a + (1 - f) * b`` with one fused multiply-add, the
    reference's evaluation of the same expression."""
    if mode == "eafl":
        r = fma(f32(f, a), a, f32(1.0 - f, b) * b)
    elif mode == "oort":
        r = a
    elif mode == "eafl-epj":
        r = a / torch.maximum(b, f32(1e-3, b))
    else:
        raise ValueError(mode)
    if ucb is not None:
        r = r * (1.0 + ucb)
    return torch.where(valid != 0, r, f32(SENTINEL, r))


def topk_reward(a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor, *,
                f: float, k: int, ucb=None, mode: str = "eafl",
                index_offset: int = 0):
    """Score + top-k: ``(values (k,) f32, indices (k,) int32)``.

    The order is ``lax.top_k``'s: a stable descending sort of the scores'
    :func:`~repro_torch.numerics.orderable_key` (+0 above -0, +NaN first,
    -NaN last), so ties go lowest index first, as the blocked reference
    kernel orders them. ``index_offset`` shifts the returned indices."""
    score = reward_score(a, b, valid, f=f, ucb=ucb, mode=mode)
    top = torch.sort(orderable_key(score), descending=True,
                     stable=True).indices[:k]
    return score[top], top.to(torch.int32) + int(index_offset)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """f32 ``(B, H, S, S)`` scores of q ``(B, S, H, hd)`` against k
    ``(B, S, H, hd)`` (KV heads already repeated): the product in the
    input dtype, then f32 times ``hd**-0.5``, the causal mask at -1e30."""
    S, hd = q.shape[1], q.shape[3]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd ** -0.5
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, f32(-1e30, scores))
    return scores


def _repeat_kv(t: torch.Tensor, G: int) -> torch.Tensor:
    return t.repeat_interleave(G, dim=2) if G > 1 else t


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Plain softmax attention. q: ``(B, S, H, hd)``; k, v:
    ``(B, S, KH, hd)``, query head ``h`` reading KV head ``h // (H // KH)``.

    As ``flash_attention_ref``: scores in the input dtype, then f32 times
    ``hd**-0.5``, causal mask ``-1e30``, f32 softmax, weights cast back to
    the input dtype before the product with v."""
    G = q.shape[2] // k.shape[2]
    w = torch.softmax(_scores(q, _repeat_kv(k, G), causal),
                      dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, _repeat_kv(v, G))


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True):
    """:func:`flash_attention` and the natural-log log-sum-exp of each
    query row's scaled, masked scores: ``(o, lse)``, lse f32 ``(B, H, S)``
    (the kernel's forward saves it for the backward)."""
    G = q.shape[2] // k.shape[2]
    scores = _scores(q, _repeat_kv(k, G), causal)
    lse = torch.logsumexp(scores, dim=-1)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, _repeat_kv(v, G)), lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True):
    """The gradient of :func:`flash_attention`: ``(dq, dk, dv)`` in the
    inputs' dtypes, from the explicit formulas in f32 (the function it
    differentiates rounds nothing in f32): P = exp(s - lse) recomputed
    from the scores and the forward's ``lse``, dV = P^T dO, D_i =
    rowsum(dO o O), dS = P o (dO V^T - D), dQ = scale dS K, dK = scale
    dS^T Q, with dK and dV summed over each KV head's H / KH query
    heads. The plain version of the backward kernel; the model's plain
    route differentiates its own attention by autograd instead."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = hd ** -0.5
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    kr, vr = _repeat_kv(kf, G), _repeat_kv(vf, G)
    p = torch.exp(_scores(qf, kr, causal) - lse.float()[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    delta = (dof * of).sum(-1).transpose(1, 2)                # (B, H, S)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    if G > 1:
        dk = dk.reshape(B, S, KH, G, hd).sum(3)
        dv = dv.reshape(B, S, KH, G, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssd_chunk(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
              dt: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Mamba2 / SSD as the sequential recurrence of ``ssd_chunk_ref``, in
    f32: ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) x_t``, ``y_t = C_t .
    h_t``. x: ``(B, S, nh, hd)``; Bm, Cm: ``(B, S, ds)``; dt: ``(B, S, nh)``;
    A: ``(nh,)``. Returns ``(B, S, nh, hd)`` in x's dtype."""
    Bsz, S, nh, hd = x.shape
    out_dtype = x.dtype
    x, Bm, Cm, dt = (t.float() for t in (x, Bm, Cm, dt))
    A = A.float()
    h = torch.zeros(Bsz, nh, Bm.shape[-1], hd, dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        da = torch.exp(dt[:, t] * A)                              # (B, nh)
        upd = (dt[:, t, :, None, None] * Bm[:, t, None, :, None]
               * x[:, t, :, None, :])                             # (B,nh,ds,hd)
        h = da[..., None, None] * h + upd
        ys.append(torch.einsum("bhsd,bs->bhd", h, Cm[:, t]))
    return torch.stack(ys, dim=1).to(out_dtype)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor,
                   D: torch.Tensor) -> torch.Tensor:
    """Mamba1 selective scan as the sequential recurrence of
    ``selective_scan_ref``, in f32: ``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t)
    B_t``, ``y_t = C_t . h_t + D x_t``. x, dt: ``(B, S, di)``; Bm, Cm:
    ``(B, S, ds)``; A: ``(di, ds)``; D: ``(di,)``. Returns ``(B, S, di)``
    in x's dtype, rounded once."""
    Bsz, S, di = x.shape
    out_dtype = x.dtype
    x, dt, Bm, Cm, A, D = (t.float() for t in (x, dt, Bm, Cm, A, D))
    dx = dt * x
    h = torch.zeros(Bsz, di, Bm.shape[-1], dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        da = torch.exp(dt[:, t, :, None] * A)                     # (B,di,ds)
        h = da * h + dx[:, t, :, None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, Cm[:, t]))
    y = torch.stack(ys, dim=1) + x * D
    return y.to(out_dtype)
