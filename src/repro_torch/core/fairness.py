"""Fairness / participation metrics (paper Fig. 3c), in PyTorch."""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import asum


def jains_index(x: torch.Tensor, axis=None, n=None) -> torch.Tensor:
    """Jain's fairness index over per-client participation counts.

    J = (sum x)^2 / (n * sum x^2); 1/n (unfair) .. 1 (perfectly fair).
    With a ``clients`` mesh as ``axis`` (``launch/mesh.py``) ``x`` is a
    shard block ``(S, n_loc)`` padded with zeros and ``n`` the real
    client count; the sums run over the mesh.
    """
    x = x.to(torch.float32)
    n = x.shape[-1] if n is None else n
    s = asum(x, axis)
    s2 = asum(torch.square(x), axis)
    return torch.where(s2 > 0, torch.square(s) / (n * s2),
                       torch.ones_like(s))
