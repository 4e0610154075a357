"""Server-side aggregation: FedAvg deltas + adaptive server optimizers.

The paper aggregates with YoGi. The weighted-mean client delta is the
pseudo-gradient of the server optimizer (Reddi et al., Adaptive Federated
Optimization). Stacked deltas carry a leading client axis ``(C, ...)``.
"""
from __future__ import annotations

import functools
from typing import Any, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.optim import SERVER_OPTIMIZERS, Optimizer, apply_updates

PyTree = Any


def weighted_delta(deltas: PyTree, weights: torch.Tensor) -> PyTree:
    """deltas: tree with leading client axis (C, ...); weights: (C,)."""
    w = weights / torch.clamp_min(weights.sum(), 1e-9)
    return tree_map(lambda d: torch.tensordot(w.to(d.dtype), d, dims=1),
                    deltas)


# --------------------------------------------------- non-finite quarantine
# A client that uploads a non-finite delta is quarantined: its weight is
# zeroed and its delta replaced by zeros (0 * nan is nan), and a last gate
# on the aggregate keeps an overflow out of the global params.

def finite_rows(deltas: PyTree) -> torch.Tensor:
    """(C,) bool: True where every element of client j's delta is finite."""
    masks = [torch.isfinite(d.reshape(d.shape[0], -1)).all(dim=1)
             for d in tree_leaves(deltas)]
    return functools.reduce(torch.logical_and, masks)


def zero_nonfinite_rows(deltas: PyTree, finite: torch.Tensor) -> PyTree:
    """Replace quarantined clients' delta rows with zeros."""
    def clean(d):
        shape = (finite.shape[0],) + (1,) * (d.ndim - 1)
        return torch.where(finite.reshape(shape), d, torch.zeros_like(d))
    return tree_map(clean, deltas)


def tree_finite(tree: PyTree) -> torch.Tensor:
    """Scalar bool: every element of every leaf is finite."""
    checks = [torch.isfinite(leaf).all() for leaf in tree_leaves(tree)]
    return functools.reduce(torch.logical_and, checks)


def make_server_optimizer(name: str, lr: float) -> Optimizer:
    if name not in SERVER_OPTIMIZERS:
        raise KeyError(f"unknown server optimizer {name!r}")
    return SERVER_OPTIMIZERS[name](lr)


def server_update(params: PyTree, agg_delta: PyTree, opt: Optimizer,
                  opt_state: PyTree) -> Tuple[PyTree, PyTree]:
    """Pseudo-gradient = -delta (so +delta is the descent direction)."""
    pseudo_grad = tree_map(lambda d: -d, agg_delta)
    updates, opt_state = opt.update(pseudo_grad, opt_state, params)
    return apply_updates(params, updates), opt_state
