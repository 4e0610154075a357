"""Mamba1 selective scan & Mamba2 (SSD) blocks, prefill + single-step decode.

The port's ``repro/models/mamba.py``. On a CUDA tensor each prefill scan
runs a Hopper kernel in place of the reference's plain lines:

- Mamba1 (falcon-mamba-7b): :func:`repro_torch.kernels.ops.selective_scan`
  (the port of the reference's Pallas ``selective_scan``, D skip included)
  in place of ``mamba1_forward``'s ``lax.scan`` (``:93-104``). Elsewhere
  it runs that recurrence as a loop over time.
- Mamba2 (zamba2): :func:`repro_torch.kernels.ops.ssd_chunk` (the port of
  the Pallas ``ssd_chunk``) in place of ``mamba2_forward``'s chunked SSD
  lines (``:172-210``). Elsewhere it runs that chunked form
  (``SSD_CHUNK`` steps a chunk).

Both kernels are differentiable: in training (under grad) each runs its
own backward kernel on the card (``ops.ssd_chunk_bwd``,
``ops.selective_scan_bwd``), where the reference differentiates its
plain lines.

``use_kernel`` overrides the choice by device, so the plain routes can
also run on the card. Decoding has no kernel in the reference and stays
plain tensor code; it returns a new cache and leaves the given one as it
is.

The two routes compute the same scans but round differently in bf16. The
plain Mamba1 route, like the reference, forms ``dt * x`` in the compute
dtype, casts y to it at every step and adds the D skip in it; the kernel
keeps all of it in f32 and rounds y once. The plain Mamba2 route casts the
intra-chunk weights and the chunk states to the compute dtype before their
products; the kernel keeps all of it in f32 and rounds y once.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, normal_init, rms_norm

Params = Dict[str, torch.Tensor]

SSD_CHUNK = 128


# ---------------------------------------------------------------- conv utils
def causal_conv(x, w, b):
    """Depthwise causal conv. x: (B,S,C); w: (C,K); b: (C)."""
    K = w.shape[-1]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = pad[:, 0:S, :] * w[:, 0]
    for i in range(1, K):
        out = out + pad[:, i:i + S, :] * w[:, i]
    return out + b


def conv_step(conv_state, x_new, w, b):
    """One decode step. conv_state: (B,K-1,C) past inputs; x_new: (B,C)."""
    window = torch.cat([conv_state, x_new[:, None, :]], dim=1)   # (B,K,C)
    out = torch.einsum("bkc,ck->bc", window, w) + b
    return out, window[:, 1:, :]


# ------------------------------------------------------------------- mamba1
def init_mamba1(gen: torch.Generator, cfg) -> Params:
    D, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr = cfg.resolved_dt_rank
    dev = gen.device
    f32 = torch.float32
    A = torch.arange(1, ds + 1, dtype=f32, device=dev).expand(di, ds)
    return {
        "in_proj": dense_init(gen, D, 2 * di, cfg.param_dtype),
        "conv_w": normal_init(gen, (di, cfg.ssm_conv), 0.5, f32),
        "conv_b": torch.zeros((di,), dtype=f32, device=dev),
        "x_proj": dense_init(gen, di, dtr + 2 * ds, cfg.param_dtype),
        "dt_proj": dense_init(gen, dtr, di, cfg.param_dtype),
        "dt_bias": normal_init(gen, (di,), 0.5, f32),
        "A_log": torch.log(A.contiguous()),
        "D": torch.ones((di,), dtype=f32, device=dev),
        "out_proj": dense_init(gen, di, D, cfg.param_dtype),
    }


def _mamba1_inputs(cfg, p, x):
    """x (..., D) -> the scan's input xs and the gate z, (..., di) each."""
    xs, z = torch.chunk(x @ p["in_proj"].to(cfg.compute_dtype), 2, dim=-1)
    return xs, z


def _mamba1_ssm_params(cfg, p, xs):
    """xs: post-conv activations (..., di) -> dt (..., di), B, C (..., ds);
    B and C are slices of one projection (strided views, no copy)."""
    cd = cfg.compute_dtype
    ds, dtr = cfg.ssm_state, cfg.resolved_dt_rank
    dbc = xs @ p["x_proj"].to(cd)
    dt, Bm, Cm = torch.split(dbc, [dtr, ds, ds], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"].to(cd) + p["dt_bias"].to(cd))
    return dt, Bm, Cm


def _mamba1_scan(cfg, xs, dt, Bm, Cm, A, D):
    """The reference's recurrence (``mamba1_forward``, ``:93-104``) with its
    casts: ``dt * x`` in the compute dtype, then f32; y cast to the compute
    dtype every step; the D skip added in the compute dtype."""
    cd = cfg.compute_dtype
    B, S, di = xs.shape
    dx = (dt * xs).float()
    dtf, Bf, Cf = dt.float(), Bm.float(), Cm.float()
    h = torch.zeros(B, di, Bm.shape[-1], dtype=torch.float32,
                    device=xs.device)
    ys = []
    for t in range(S):
        da = torch.exp(dtf[:, t, :, None] * A)                    # (B,di,ds)
        h = da * h + dx[:, t, :, None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, Cf[:, t]).to(cd))
    return torch.stack(ys, dim=1) + xs * D.to(cd)


def mamba1_forward(cfg, p: Params, x, use_kernel: Optional[bool] = None):
    """Selective scan over a full sequence. x: (B,S,D) -> (B,S,D).

    ``use_kernel`` (default: whether x is on CUDA) picks the Hopper kernel
    over the plain loop over time."""
    cd = cfg.compute_dtype
    if use_kernel is None:
        use_kernel = x.is_cuda
    xs, z = _mamba1_inputs(cfg, p, x)
    xs = F.silu(causal_conv(xs, p["conv_w"].to(cd), p["conv_b"].to(cd)))
    dt, Bm, Cm = _mamba1_ssm_params(cfg, p, xs)
    A = -torch.exp(p["A_log"])                                    # (di, ds)
    if use_kernel:
        y = ops.selective_scan(xs, dt, Bm, Cm, A, p["D"])
    else:
        y = _mamba1_scan(cfg, xs, dt, Bm, Cm, A, p["D"])
    y = y * F.silu(z)
    return y @ p["out_proj"].to(cd)


def init_mamba1_cache(cfg, batch: int, dtype, device=None) -> Params:
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def mamba1_decode(cfg, p: Params, x, cache):
    """One-token decode. x: (B,1,D). Returns (out (B,1,D), new cache)."""
    cd = cfg.compute_dtype
    xs, z = _mamba1_inputs(cfg, p, x[:, 0])
    xs, conv_state = conv_step(cache["conv"], xs,
                               p["conv_w"].to(cd), p["conv_b"].to(cd))
    xs = F.silu(xs)
    dt, Bm, Cm = _mamba1_ssm_params(cfg, p, xs)
    A = -torch.exp(p["A_log"])
    da = torch.exp(dt.float()[..., None] * A)
    h = da * cache["ssm"] + (dt * xs).float()[..., None] \
        * Bm.float()[:, None, :]
    y = torch.einsum("bds,bs->bd", h, Cm.float()).to(cd)
    y = y + xs * p["D"].to(cd)
    y = y * F.silu(z)
    out = (y @ p["out_proj"].to(cd))[:, None, :]
    return out, {"conv": conv_state.to(cache["conv"].dtype), "ssm": h}


# ------------------------------------------------------------------- mamba2
def init_mamba2(gen: torch.Generator, cfg) -> Params:
    D, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.ssm_n_heads
    conv_ch = di + 2 * ds
    dev = gen.device
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, D, 2 * di + 2 * ds + nh, cfg.param_dtype),
        "conv_w": normal_init(gen, (conv_ch, cfg.ssm_conv), 0.5, f32),
        "conv_b": torch.zeros((conv_ch,), dtype=f32, device=dev),
        "dt_bias": normal_init(gen, (nh,), 0.5, f32),
        "A_log": torch.zeros((nh,), dtype=f32, device=dev),
        "D": torch.ones((nh,), dtype=f32, device=dev),
        "gate_norm": torch.ones((di,), dtype=f32, device=dev),
        "out_proj": dense_init(gen, di, D, cfg.param_dtype),
    }


def _mamba2_inputs(cfg, p, x):
    cd = cfg.compute_dtype
    di, ds = cfg.d_inner, cfg.ssm_state
    zxbcdt = x @ p["in_proj"].to(cd)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * ds, cfg.ssm_n_heads],
                             dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                   # (..., nh)
    return z, xbc, dt


def _ssd_chunked(cfg, xh, Bm, Cm, dt, A):
    """The reference's chunked SSD (``mamba2_forward``, ``:172-210``):
    xh (B,S,nh,hd) in the compute dtype, Bm/Cm (B,S,ds), dt (B,S,nh) f32,
    A (nh,) -> y (B,S,nh,hd), with the reference's casts."""
    B, S, nh, hd = xh.shape
    ds = Bm.shape[-1]
    cd = cfg.compute_dtype
    Q = min(SSD_CHUNK, S)
    if S % Q:
        raise ValueError(f"S={S} must be a multiple of the chunk {Q}")
    nc = S // Q
    xc = xh.reshape(B, nc, Q, nh, hd)
    Bc = Bm.reshape(B, nc, Q, ds).float()
    Cc = Cm.reshape(B, nc, Q, ds).float()
    dtc = dt.reshape(B, nc, Q, nh)

    lcum = torch.cumsum(dtc * A, dim=2)                           # inclusive
    G = torch.einsum("bcqs,bcks->bcqk", Cc, Bc)                   # (B,nc,Q,Q)
    delta = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]       # (B,nc,Q,Q,nh)
    mask = torch.ones(Q, Q, dtype=torch.bool, device=xh.device).tril()
    mask = mask[None, None, :, :, None]
    zero = torch.zeros((), dtype=delta.dtype, device=xh.device)
    # the exponent is masked too: above the diagonal exp(delta) may
    # overflow, and its backward would then be 0 * inf = NaN
    M = torch.where(mask, torch.exp(torch.where(mask, delta, zero)), zero)
    att = G[..., None] * M * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcqkh,bckhd->bcqhd", att.to(cd), xc)

    decay_to_end = torch.exp(lcum[:, :, -1:, :] - lcum)           # (B,nc,Q,nh)
    weighted_x = (decay_to_end * dtc)[..., None].to(cd) * xc
    S_c = torch.einsum("bcqs,bcqhd->bchsd", Bc.to(cd), weighted_x)

    chunk_decay = torch.exp(lcum[:, :, -1, :])                    # (B,nc,nh)
    h = torch.zeros(B, nh, ds, hd, dtype=torch.float32, device=xh.device)
    h_prev = []
    for c in range(nc):                    # emit the state BEFORE each chunk
        h_prev.append(h)
        h = chunk_decay[:, c, :, None, None] * h + S_c[:, c].float()
    h_prev = torch.stack(h_prev, dim=1)                           # (B,nc,nh,ds,hd)

    Ct_scaled = Cc[..., None, :] * torch.exp(lcum)[..., :, None]  # (B,nc,Q,nh,ds)
    y_inter = torch.einsum("bcqhs,bchsd->bcqhd", Ct_scaled.to(cd),
                           h_prev.to(cd))
    return (y_intra + y_inter).reshape(B, S, nh, hd)


def mamba2_forward(cfg, p: Params, x, use_kernel: Optional[bool] = None):
    """SSD over a full sequence. x: (B,S,D) -> (B,S,D).

    ``use_kernel`` (default: whether x is on CUDA) picks the Hopper kernel
    over the plain chunked route."""
    B, S, D = x.shape
    cd = cfg.compute_dtype
    di, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads, cfg.ssm_head_dim
    if use_kernel is None:
        use_kernel = x.is_cuda

    z, xbc, dt = _mamba2_inputs(cfg, p, x)
    xbc = F.silu(causal_conv(xbc, p["conv_w"].to(cd), p["conv_b"].to(cd)))
    xs, Bm, Cm = torch.split(xbc, [di, ds, ds], dim=-1)
    xh = xs.reshape(B, S, nh, hd)          # a strided view: no copy
    A = -torch.exp(p["A_log"])                                    # (nh,)
    if use_kernel:
        y = ops.ssd_chunk(xh, Bm, Cm, dt, A)
    else:
        y = _ssd_chunked(cfg, xh, Bm, Cm, dt, A)
    y = y.reshape(B, S, di)
    y = y + xs * torch.repeat_interleave(p["D"].to(cd), hd)[None, None, :]
    y = rms_norm(y * F.silu(z), p["gate_norm"])
    return y @ p["out_proj"].to(cd)


def init_mamba2_cache(cfg, batch: int, dtype, device=None) -> Params:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.ssm_n_heads, cfg.ssm_state,
                            cfg.ssm_head_dim), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(cfg, p: Params, x, cache):
    """One-token decode. x: (B,1,D). Returns (out (B,1,D), new cache)."""
    cd = cfg.compute_dtype
    di, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads, cfg.ssm_head_dim
    B = x.shape[0]
    z, xbc, dt = _mamba2_inputs(cfg, p, x[:, 0])
    xbc, conv_state = conv_step(cache["conv"], xbc,
                                p["conv_w"].to(cd), p["conv_b"].to(cd))
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [di, ds, ds], dim=-1)
    xh = xs.reshape(B, nh, hd)
    A = -torch.exp(p["A_log"])
    da = torch.exp(dt * A)                                        # (B,nh)
    upd = torch.einsum("bh,bs,bhd->bhsd", dt, Bm.float(), xh.float())
    h = da[..., None, None] * cache["ssm"] + upd
    y = torch.einsum("bhsd,bs->bhd", h, Cm.float()).reshape(B, di).to(cd)
    y = y + xs * torch.repeat_interleave(p["D"].to(cd), hd)[None, :]
    y = rms_norm(y * F.silu(z), p["gate_norm"])
    out = (y @ p["out_proj"].to(cd))[:, None, :]
    return out, {"conv": conv_state.to(cache["conv"].dtype), "ssm": h}
