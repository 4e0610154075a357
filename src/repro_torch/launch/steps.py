"""The step functions of the serving path.

``prefill_step``: full-sequence forward producing logits.
``serve_step``: one-token decode against the KV/SSM cache.
``make_train_step`` comes with the training slice.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.device import DeviceLike
from repro_torch.models.transformer import decode_step, forward_logits


def make_prefill_step(cfg, device: DeviceLike = None) -> Callable:
    def prefill_step(params, batch):
        return forward_logits(cfg, params, batch, device=device)

    return prefill_step


def make_serve_step(cfg, ring: bool, device: DeviceLike = None) -> Callable:
    def serve_step(params, batch, cache, cache_index):
        return decode_step(cfg, params, batch, cache, cache_index, ring=ring,
                           device=device)

    return serve_step
