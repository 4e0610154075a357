"""The step functions of the training and serving paths.

``train_step``: one cohort AdamW step (the inner step of a federated round
at datacenter scale: the FedAvg sum over the cohort is the batch mean).
``prefill_step``: full-sequence forward producing logits.
``serve_step``: one-token decode against the KV/SSM cache.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.device import DeviceLike
from repro_torch.models.transformer import (decode_step, forward_logits,
                                            loss_fn)
from repro_torch.optim import Optimizer, adamw, apply_updates


def make_train_step(cfg, optimizer: Optimizer, remat: bool = True,
                    device: DeviceLike = None,
                    use_kernel: Optional[bool] = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss,
    metrics)``, functional as the reference's: the gradient of
    :func:`~repro_torch.models.transformer.loss_fn` by autograd, then the
    optimizer's update and ``apply_updates``; the given params and state
    are not modified. ``loss`` and ``metrics`` are detached 0-d tensors on
    the device (reading them is the caller's host sync). ``use_kernel``
    as in :func:`~repro_torch.models.transformer.loss_fn` (the dry-run
    sets it, so fake tensors on any device trace the kernels' fake
    routes)."""
    def train_step(params, opt_state, batch):
        leaves, spec = tree_flatten(params)
        live = [i for i, t in enumerate(leaves) if t is not None]
        leaves = list(leaves)
        for i in live:
            leaves[i] = leaves[i].detach().requires_grad_(True)
        loss, metrics = loss_fn(cfg, tree_unflatten(leaves, spec), batch,
                                remat=remat, device=device,
                                use_kernel=use_kernel)
        grads = torch.autograd.grad(loss, [leaves[i] for i in live])
        for i, g in zip(live, grads):
            leaves[i] = g
        del grads
        updates, opt_state = optimizer.update(tree_unflatten(leaves, spec),
                                              opt_state, params)
        del leaves
        params = apply_updates(params, updates)
        return (params, opt_state, loss.detach(),
                {k: v.detach() for k, v in metrics.items()})

    return train_step


def make_prefill_step(cfg, device: DeviceLike = None,
                      use_kernel: Optional[bool] = None) -> Callable:
    def prefill_step(params, batch):
        return forward_logits(cfg, params, batch, device=device,
                              use_kernel=use_kernel)

    return prefill_step


def make_serve_step(cfg, ring: bool, device: DeviceLike = None) -> Callable:
    def serve_step(params, batch, cache, cache_index):
        return decode_step(cfg, params, batch, cache, cache_index, ring=ring,
                           device=device)

    return serve_step


def default_optimizer(lr: float = 1e-4) -> Optimizer:
    return adamw(lr, weight_decay=0.01)
