"""EAFL reward (Eq. 1) and Oort utility (Eq. 2), in PyTorch.

Eq. 2 (Oort):  Util(i) = |B_i| * sqrt(mean_k Loss(k)^2) * (T/t_i)^{1(T<t_i)*alpha}
Eq. 1 (EAFL):  reward(i) = f * Util(i) + (1-f) * power(i)

``power(i)`` is the battery % projected to remain after the upcoming round.
Util and power are min-max normalised over the candidate set before mixing,
as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.numerics import f32, fma


def stat_utility(per_sample_loss: torch.Tensor, n_samples) -> torch.Tensor:
    """|B_i| * sqrt(mean loss^2) over a client's local batch."""
    rms = torch.sqrt(torch.mean(torch.square(per_sample_loss), dim=-1))
    return n_samples * rms


def system_penalty(T, t_i: torch.Tensor, alpha: float = 2.0):
    """(T/t_i)^{1(T<t_i)*alpha}: penalise clients slower than the pacer T."""
    T = torch.as_tensor(T, dtype=torch.float32, device=t_i.device)
    slow = t_i > T
    ratio = torch.clamp_min(T, 1e-9) / torch.clamp_min(t_i, 1e-9)
    pen = torch.square(ratio) if alpha == 2.0 else torch.pow(ratio, alpha)
    return torch.where(slow, pen, torch.ones_like(pen))


def oort_utility(stat_util: torch.Tensor, t_i: torch.Tensor, T,
                 alpha: float = 2.0) -> torch.Tensor:
    return stat_util * system_penalty(T, t_i, alpha)


def projected_power(battery_pct: torch.Tensor,
                    predicted_round_cost_pct: torch.Tensor) -> torch.Tensor:
    """power(i): remaining battery % after the upcoming round (floored at 0)."""
    return torch.clamp_min(battery_pct - predicted_round_cost_pct, 0.0)


def minmax_range(x: torch.Tensor, valid: torch.Tensor):
    """(lo, range) of ``x`` over the ``valid`` subset (range floored)."""
    inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    lo = torch.where(valid, x, inf).min()
    hi = torch.where(valid, x, -inf).max()
    return lo, torch.clamp_min(hi - lo, 1e-9)


def minmax_normalize(x: torch.Tensor, valid: torch.Tensor, stats=None):
    """Min-max normalise ``x`` over the ``valid`` subset (0 elsewhere)."""
    lo, rng = minmax_range(x, valid) if stats is None else stats
    return torch.where(valid, (x - lo) / rng, torch.zeros_like(x))


def mix(f: float, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``f * a + (1 - f) * b`` as the reference evaluates it: ``f`` and
    ``1 - f`` rounded to float32 from double, one fused multiply-add."""
    return fma(f32(f, a), a, f32(1.0 - f, b) * b)


def eafl_reward(util: torch.Tensor, power: torch.Tensor, f: float,
                valid: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Eq. 1. ``valid`` masks selectable clients (alive & available)."""
    if normalize:
        util = minmax_normalize(util, valid)
        power = minmax_normalize(power, valid)
    r = mix(f, util, power)
    return torch.where(valid, r, torch.full_like(r, float("-inf")))
