"""Fake-tensor stand-ins for every model input (dry-run, no allocation).

The port's ``repro/launch/specs.py``. Where the reference returns
``jax.ShapeDtypeStruct`` trees (parameters and caches from
``jax.eval_shape``), these functions return ``FakeTensor`` trees: each
must be called inside a ``torch._subclasses.fake_tensor.FakeTensorMode``
that the caller owns (and raises outside one), so nothing is allocated on
any device, and a step traced on them (``launch/dryrun.py``) sees the
shapes, dtypes and device of a real run. ``device`` is the device the
fake tensors describe (CUDA by default).

``input_specs(cfg, shape)`` is the batch for the workload shape;
``params_specs`` the parameters of ``models.transformer.init_params``;
``cache_specs`` its ``init_cache`` at ``cache_len_for``'s length.

Modality carve-out, as the reference's: for the vision and audio archs
the frontend is a stub; vision patch embeddings and codec frame tokens
arrive precomputed with the right shapes.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_map

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.transformer import init_cache, init_params


def _device(device: DeviceLike) -> torch.device:
    """``device`` as a ``torch.device`` (CUDA by default), once a
    ``FakeTensorMode`` is known to be open."""
    if not any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack()):
        raise RuntimeError("the specs are fake tensors: call them inside "
                           "a FakeTensorMode")
    return torch.device("cuda" if device is None else device)


def input_specs(cfg: ModelConfig, shape: InputShape,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The batch: ``tokens`` (and, training, ``labels``) int32 ``(B, T)``,
    ``(B, T, ncb)`` with codebooks, T the text positions (S less the
    patches with the vision frontend), and the f32 ``vision_embeds`` ``(B,
    P, D)``; decoding, ONE new token ``(B, 1)`` against a ``seq_len``-deep
    cache."""
    dev = _device(device)
    B, S = shape.global_batch, shape.seq_len

    def ints(*dims):
        return torch.empty(dims, dtype=torch.int32, device=dev)

    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    if shape.mode in ("train", "prefill"):
        text_len = S - cfg.n_patches if cfg.frontend == "vision" else S
        batch: Dict[str, Any] = {"tokens": ints(B, text_len, *books)}
        if shape.mode == "train":
            batch["labels"] = ints(B, text_len, *books)
        if cfg.frontend == "vision":
            batch["vision_embeds"] = torch.empty(
                (B, cfg.n_patches, cfg.d_model), dtype=torch.float32,
                device=dev)
        return batch
    return {"tokens": ints(B, 1, *books)}


def cache_len_for(cfg: ModelConfig, shape: InputShape) -> int:
    if shape.sliding_window and cfg.attn_kind != "none":
        return shape.sliding_window
    return shape.seq_len


def params_specs(cfg: ModelConfig, device: DeviceLike = None):
    """``init_params(0, cfg)``'s tree. It is built on the fake CPU (a
    CUDA generator cannot be faked without a CUDA build) and each leaf is
    then made again on ``device`` with ``empty_like``."""
    dev = _device(device)
    params = init_params(0, cfg, device="cpu")
    if dev.type == "cpu":
        return params
    return tree_map(lambda t: None if t is None
                    else torch.empty_like(t, device=dev), params)


def cache_specs(cfg: ModelConfig, shape: InputShape,
                device: DeviceLike = None):
    """``init_cache`` in bf16 for ``shape.global_batch`` rows of
    :func:`cache_len_for` positions."""
    return init_cache(cfg, shape.global_batch, cache_len_for(cfg, shape),
                      torch.bfloat16, device=_device(device))
