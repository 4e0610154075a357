"""Fairness / participation metrics (paper Fig. 3c), in PyTorch."""
from __future__ import annotations

import torch


def jains_index(x: torch.Tensor) -> torch.Tensor:
    """Jain's fairness index over per-client participation counts.

    J = (sum x)^2 / (n * sum x^2); 1/n (unfair) .. 1 (perfectly fair).
    """
    x = x.to(torch.float32)
    n = x.shape[0]
    s = torch.sum(x)
    s2 = torch.sum(torch.square(x))
    return torch.where(s2 > 0, torch.square(s) / (n * s2),
                       torch.ones_like(s))
