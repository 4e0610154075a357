"""Functional optimizers over parameter trees, in PyTorch.

Each optimizer is an (init, update) pair over nested dicts/lists of tensors:
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``yogi`` is the paper's server aggregation optimizer; ``fedadam`` /
``fedadagrad`` are the adaptive-FL baselines; ``sgd`` (+momentum) is the
plain step. Arithmetic follows the reference's order in float32.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch.utils._pytree import tree_map

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, Optional[PyTree]], Tuple[PyTree, PyTree]]


def _map(fn, tree: PyTree, *rest: PyTree) -> PyTree:
    """``tree_map`` over the tensors of ``tree``; a ``None`` leaf (an LM
    stage whose weights live elsewhere, which JAX's trees hold as an
    empty subtree) stays ``None``."""
    return tree_map(lambda x, *r: None if x is None else fn(x, *r), tree,
                    *rest)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return _map(lambda p, u: p + u.to(p.dtype), params, updates)


def _zeros_like_f32(params):
    return _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": _zeros_like_f32(params)} if momentum else {}

    def update(grads, state, params=None):
        if momentum:
            mu = _map(lambda m, g: momentum * m + g.float(),
                          state["mu"], grads)
            return _map(lambda m: -lr * m, mu), {"mu": mu}
        return _map(lambda g: -lr * g.float(), grads), state

    return Optimizer(init, update)


def _adaptive(lr, b1, b2, eps, variant: str) -> Optimizer:
    def init(params):
        # the step count is a 0-d CPU tensor (CUDA ops take it as a
        # scalar); an engine replayed from a CUDA graph moves it to the card
        return {"m": _zeros_like_f32(params), "v": _zeros_like_f32(params),
                "t": torch.zeros((), dtype=torch.int32)}

    def update(grads, state, params=None):
        t = state["t"] + 1
        m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)

        def upd_v(v_, g):
            g2 = torch.square(g.float())
            if variant == "adam":
                return b2 * v_ + (1 - b2) * g2
            if variant == "yogi":
                return v_ - (1 - b2) * torch.sign(v_ - g2) * g2
            if variant == "adagrad":
                return v_ + g2
            raise ValueError(variant)

        v = _map(upd_v, state["v"], grads)
        if variant == "adagrad":
            def step(m_, v_):
                return -lr * m_ / (torch.sqrt(v_) + eps)
        else:
            tf = t.to(torch.float32)
            bc1 = 1 - torch.pow(torch.full((), b1, device=t.device), tf)
            bc2 = 1 - torch.pow(torch.full((), b2, device=t.device), tf)

            def step(m_, v_):
                mhat = m_ / bc1
                vhat = v_ / bc2
                return -lr * mhat / (torch.sqrt(vhat) + eps)

        return _map(step, m, v), {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    return _adaptive(lr, b1, b2, eps, "adam")


def yogi(lr: float, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-3):
    """YoGi, the paper's server optimizer (additive quadratic control)."""
    return _adaptive(lr, b1, b2, eps, "yogi")


def adagrad(lr: float, eps: float = 1e-8):
    return _adaptive(lr, 0.9, 0.0, eps, "adagrad")


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    base = adam(lr, b1, b2, eps)

    def update(grads, state, params):
        updates, state2 = base.update(grads, state, params)
        if weight_decay:
            updates = _map(lambda u, p: u - lr * weight_decay * p.float(),
                               updates, params)
        return updates, state2

    return Optimizer(base.init, update)


SERVER_OPTIMIZERS = {
    "yogi": yogi,
    "fedadam": adam,
    "fedadagrad": adagrad,
    "fedavg": lambda lr=1.0: sgd(lr),
}
