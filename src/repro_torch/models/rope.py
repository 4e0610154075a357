"""Rotary position embeddings (half-dim rotation convention)."""
from __future__ import annotations

import torch


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S) integer.

    The angles are f32; the two halves of the last axis are rotated."""
    dim = x.shape[-1]
    inv = rope_freqs(dim, theta, x.device)                  # (D/2,)
    ang = positions.float()[..., None] * inv                # (..., S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.ndim == positions.ndim + 2:                        # head axis present
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
