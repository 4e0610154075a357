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


def ssd_chunk_bwd(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                  dt: torch.Tensor, A: torch.Tensor, dy: torch.Tensor):
    """The gradient of :func:`ssd_chunk`: ``(dx, dBm, dCm, ddt, dA)`` from
    the forward's inputs and the output's gradient ``dy``, by the explicit
    reverse recurrence in f32. With a = exp(dt_t A), the state h_t = a
    h_{t-1} + dt_t B_t (x) x_t and g_t = C_t (x) dy_t + a_{t+1} g_{t+1}
    (the gradient of the loss with respect to h_t): dx_t = dt_t B_t^T g_t,
    dB_t = sum_h dt_t g_t x_t, dC_t = sum_h h_t dy_t, ddt_t = <g_t, A a
    h_{t-1} + B_t (x) x_t>, dA = sum_{b,t} dt a <g_t, h_{t-1}>. dx, dBm
    and dCm come in their inputs' dtypes, ddt and dA in f32 (the kernel
    reads dt and A as f32). The plain version of the backward kernel
    (``csrc/ssd_chunk_bwd.cu``), which has no Pallas counterpart: the
    reference differentiates its pure-jnp SSD."""
    Bsz, S, nh, hd = x.shape
    xf, Bf, Cf, dtf, dyf = (t.float() for t in (x, Bm, Cm, dt, dy))
    A = A.float()
    h = torch.zeros(Bsz, nh, Bm.shape[-1], hd, dtype=torch.float32,
                    device=x.device)
    before = []                                   # h_{t-1} for each t
    for t in range(S):
        before.append(h)
        h = (torch.exp(dtf[:, t] * A)[..., None, None] * h
             + dtf[:, t, :, None, None] * Bf[:, t, None, :, None]
             * xf[:, t, :, None, :])
    dx, dB, dC, ddt = (torch.empty_like(t) for t in (xf, Bf, Cf, dtf))
    dA = torch.zeros_like(A)
    g = torch.zeros_like(h)
    for t in reversed(range(S)):
        a = torch.exp(dtf[:, t] * A)                              # (B, nh)
        g = g + Cf[:, t, None, :, None] * dyf[:, t, :, None, :]
        z = torch.einsum("bhsd,bs->bhd", g, Bf[:, t])             # B_t^T g
        dx[:, t] = dtf[:, t, :, None] * z
        dB[:, t] = torch.einsum("bhsd,bh,bhd->bs", g, dtf[:, t], xf[:, t])
        dC[:, t] = torch.einsum("bhsd,bhd->bs", h, dyf[:, t])
        gh = (g * before[t]).sum((-2, -1))              # <g_t, h_{t-1}>
        ddt[:, t] = A * a * gh + (z * xf[:, t]).sum(-1)
        dA += (dtf[:, t] * a * gh).sum(0)
        h = before[t]
        g = a[..., None, None] * g
    return dx.to(x.dtype), dB.to(Bm.dtype), dC.to(Cm.dtype), ddt, dA


def _chunks(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """``(B, S, ...)`` -> ``(B, n_chunks, chunk, ...)`` in f32, the rows
    past S zeros (dt = 0 there: no decay, no input, no gradient)."""
    B, S = t.shape[:2]
    pad = -S % chunk
    t = t.float()
    if pad:
        t = torch.cat([t, t.new_zeros((B, pad, *t.shape[2:]))], dim=1)
    return t.reshape(B, -1, chunk, *t.shape[2:])


def ssd_chunk_bwd_carry(Cm: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        dy: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """The first pass of the bf16 backward kernel (``csrc/
    ssd_chunk_bwd.cu::ssd_bwd_carry``): K, the gradient with respect to
    each chunk's last state from the later chunks, ``(B, n_chunks, nh, ds,
    hd)`` f32, by its reverse recurrence over the chunks ``K <- e^lend K +
    (e^l C)^T dy`` (l the inclusive cumulative sum of dt A within a chunk,
    lend its last value; zero for the last chunk)."""
    C, dtc, dyc = (_chunks(t, chunk) for t in (Cm, dt, dy))
    l = torch.cumsum(dtc * A.float(), dim=2)             # (B, NC, Q, nh)
    sends = torch.einsum("bcrn,bcrh,bcrhp->bchnp", C, torch.exp(l), dyc)
    decay = torch.exp(l[:, :, -1])                         # (B, NC, nh)
    out = torch.empty_like(sends)
    K = torch.zeros_like(sends[:, 0])
    for c in reversed(range(sends.shape[1])):
        out[:, c] = K
        K = decay[:, c, :, None, None] * K + sends[:, c]
    return out


def ssd_chunk_bwd_local(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                        dt: torch.Tensor, A: torch.Tensor, dy: torch.Tensor,
                        states: torch.Tensor, carry: torch.Tensor,
                        chunk: int = 64):
    """The second pass of the bf16 backward kernel (``csrc/
    ssd_chunk_bwd.cu::ssd_bwd_local``): ``(dx, dBm, dCm, ddt, dA)`` as
    :func:`ssd_chunk_bwd` returns them, each chunk's from its own inputs,
    its entering state (``states``, the forward kernel's) and its K
    (``carry``, :func:`ssd_chunk_bwd_carry`'s), in the kernel's chunk form
    in f32: with Dm[r][s] = (C_r . B_s) e^(l_r - l_s) and E[r][s] = (dy_r .
    x_s) e^(l_r - l_s) for s <= r, and W = Dm dt_s (dy_r . x_s),
    z = Dm^T dy + e^(lend - l) (B K), dx = dt z, dC = (E dt) B + e^l (dy
    h0^T), dB = dt (E^T C + e^(lend - l) (x K^T)), and m_t = <g_t, a_t
    h_{t-1}> as the running sum of W's column sums less its row sums
    (below the diagonal) plus u_r = e^(l_r) C_r . (h0 dy_r) from t on,
    v_s = e^(lend - l_s) dt_s B_s . (K x_s) before t and c = e^lend <K,
    h0>; ddt = A m + x . z, dA sums dt m."""
    Bsz, S, nh, hd = x.shape
    xc, Bc, Cc, dtc, dyc = (_chunks(t, chunk) for t in (x, Bm, Cm, dt, dy))
    A = A.float()
    K, h0 = carry.float(), states.float()          # (B, NC, nh, ds, hd)
    l = torch.cumsum(dtc * A, dim=2)                      # (B, NC, Q, nh)
    lend = l[:, :, -1:]
    ones = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device)
    below, strict = ones.tril()[..., None], ones.tril(-1)[..., None]
    diff = l[:, :, :, None] - l[:, :, None]               # l_r - l_s
    dec = torch.exp(torch.where(below, diff, float("-inf")))
    G = torch.einsum("bcrn,bcsn->bcrs", Cc, Bc)
    P = torch.einsum("bcrhp,bcshp->bcrsh", dyc, xc)
    Dm = G[..., None] * dec                               # (B, NC, r, s, nh)
    E = P * dec
    W = torch.where(strict, Dm * dtc[:, :, None] * P, 0.0)
    ed = torch.exp(lend - l)                              # e^(lend - l)
    el = torch.exp(l)
    xK = torch.einsum("bcshp,bchnp->bcshn", xc, K)
    z = (torch.einsum("bcrsh,bcrhp->bcshp", Dm, dyc)
         + ed[..., None] * torch.einsum("bcsn,bchnp->bcshp", Bc, K))
    dyh0 = torch.einsum("bcrhp,bchnp->bcrhn", dyc, h0)
    dC = (torch.einsum("bcrsh,bcsh,bcsn->bcrn", E, dtc, Bc)
          + (el[..., None] * dyh0).sum(3))
    dB = (dtc[..., None] * (torch.einsum("bcrsh,bcrn->bcshn", E, Cc)
                            + ed[..., None] * xK)).sum(3)
    u = (el[..., None] * dyh0 * Cc[:, :, :, None]).sum(-1)
    v = ed * dtc * (xK * Bc[:, :, :, None]).sum(-1)
    c = torch.exp(lend[:, :, 0]) * (K * h0).sum((-2, -1))
    w = W.sum(2) - W.sum(3)         # column sums less row sums, by step
    m = (torch.cumsum(w, 2) - w + torch.flip(torch.cumsum(
        torch.flip(u, (2,)), 2), (2,)) + torch.cumsum(v, 2) - v
         + c[:, :, None])
    ddt = A * m + (xc * z).sum(-1)
    dA = (dtc * m).sum((0, 1, 2))

    def rows(t):
        return t.reshape(Bsz, -1, *t.shape[3:])[:, :S]
    return (rows(dtc[..., None] * z).to(x.dtype), rows(dB).to(Bm.dtype),
            rows(dC).to(Cm.dtype), rows(ddt), dA)


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                       Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                       dy: torch.Tensor):
    """The gradient of :func:`selective_scan`: ``(dx, ddt, dBm, dCm, dA,
    dD)`` from the forward's inputs and the output's gradient ``dy``, by
    the explicit reverse recurrence in f32. With a = exp(dt_t A), h_t = a
    h_{t-1} + dt_t x_t B_t and g_t = C_t dy_t + a_{t+1} g_{t+1}: dx_t =
    dt_t sum_s g_t B_t + D dy_t, ddt_t = sum_s g_t (A a h_{t-1} + x_t B_t),
    dB_t = sum_d g_t dt_t x_t, dC_t = sum_d dy_t h_t, dA = sum_{b,t} g_t
    dt_t a h_{t-1}, dD = sum_{b,t} dy_t x_t. dx, ddt, dBm and dCm come in
    their inputs' dtypes, dA and dD in f32 (the kernel reads them as
    f32). The plain version of the backward kernel
    (``csrc/selective_scan_bwd.cu``), which has no Pallas counterpart: the
    reference differentiates its ``lax.scan``."""
    Bsz, S, di = x.shape
    xf, dtf, Bf, Cf, dyf = (t.float() for t in (x, dt, Bm, Cm, dy))
    A, D = A.float(), D.float()
    h = torch.zeros(Bsz, di, Bm.shape[-1], dtype=torch.float32,
                    device=x.device)
    before = []                                   # h_{t-1} for each t
    for t in range(S):
        before.append(h)
        h = (torch.exp(dtf[:, t, :, None] * A) * h
             + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :])
    dx, ddt, dB, dC = (torch.empty_like(t) for t in (xf, dtf, Bf, Cf))
    dA = torch.zeros_like(A)
    g = torch.zeros_like(h)
    for t in reversed(range(S)):
        a = torch.exp(dtf[:, t, :, None] * A)                     # (B,di,ds)
        g = g + dyf[:, t, :, None] * Cf[:, t, None, :]
        gb = (g * Bf[:, t, None, :]).sum(-1)                      # (B, di)
        dx[:, t] = dtf[:, t] * gb + D * dyf[:, t]
        gah = g * a * before[t]
        ddt[:, t] = (gah * A).sum(-1) + xf[:, t] * gb
        dB[:, t] = torch.einsum("bds,bd->bs", g, dtf[:, t] * xf[:, t])
        dC[:, t] = torch.einsum("bds,bd->bs", h, dyf[:, t])
        dA += (gah * dtf[:, t, :, None]).sum(0)
        h = before[t]
        g = a * g
    dD = (dyf * xf).sum((0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), dB.to(Bm.dtype),
            dC.to(Cm.dtype), dA, dD)
