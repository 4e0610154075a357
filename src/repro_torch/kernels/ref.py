"""Plain PyTorch versions of the port's kernels (the correctness ground
truth, and the path a wrapper takes for tensors on the CPU)."""
from __future__ import annotations

import torch

from repro_torch.numerics import f32, fma

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

    The order is a stable descending sort of the scores, so ties go lowest
    index first, as ``lax.top_k`` and the blocked reference kernel order
    them. ``index_offset`` shifts the returned indices."""
    score = reward_score(a, b, valid, f=f, ucb=ucb, mode=mode)
    top = torch.sort(score, descending=True, stable=True)
    idx = top.indices[:k].to(torch.int32) + int(index_offset)
    return top.values[:k], idx
