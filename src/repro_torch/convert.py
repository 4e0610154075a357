"""Reference state (numpy arrays) -> the port's tensors.

The reference's pytrees are handed over as numpy arrays (``np.asarray`` of
each leaf, done by the caller); nothing here imports JAX. Layouts:

- ResNet parameters: the reference's convolution weights are HWIO, the
  port's OIHW; every other leaf keeps its shape.
- Client data ``{"x": (N, M, H, W, 1), "y": (N, M)}`` and the test set
  keep the reference's NHWC layout (the port's public model functions take
  NHWC); labels become int64 for indexing.
- Optimizer state: moment trees convert like parameters; ``t`` stays a
  0-d CPU int32 tensor.
- LM parameters and caches (``repro.models.transformer``): every leaf
  keeps its shape and dtype (bf16 leaves, which numpy holds as
  ``ml_dtypes.bfloat16``, go through float32 exactly); the stacked
  ``(n, ...)`` leaves of each run of layers are unstacked into a list of
  ``n`` per-layer dicts, the layout the port's layer loop walks. A tree
  without norm weights (olmo's non-parametric LayerNorm) converts the
  same way, and so do MLA layers (``wdq``, ``q_norm``, ``wuq`` or
  ``wq``, ``wdkv``, ``kv_norm``, ``wkr``, ``wuk``, ``wuv``, ``wo``:
  ``models/mla.py``) and their latent cache (``c_kv``, ``k_rope``), and
  MoE layers (``models/moe.py``: the f32 ``router`` (D, E), the expert
  stacks ``w_gate``/``w_up`` (E, D, F) and ``w_down`` (E, F, D), stacked
  ``(n, E, ...)`` and unstacked over the layers only, and the ``shared``
  FFN), deepseek-v2-236b's leading dense layer a run of its own. The
  LM's AdamW state converts its moment trees as LM parameters
  (:func:`lm_optimizer_state`).
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.clients import _FIELDS, ClientPopulation
from repro_torch.models.transformer import build_stages
from repro_torch.device import DeviceLike, resolve_device

_POP_DTYPES = {"category": torch.int32, "network": torch.int32,
               "explored": torch.bool, "last_round": torch.int32,
               "times_selected": torch.int32, "dropped": torch.bool,
               "n_samples": torch.int32}


def tensor(x, device: DeviceLike = None, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype,
                           device=resolve_device(device))


def key(x, device: DeviceLike = None) -> torch.Tensor:
    """A reference key (uint32 pair) as the port's int64 ``(..., 2)``."""
    return tensor(np.asarray(x).astype(np.int64), device)


def resnet_params(tree: Any, device: DeviceLike = None) -> Any:
    """HWIO convolution weights -> OIHW; other leaves unchanged."""
    if isinstance(tree, Mapping):
        return {k: resnet_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [resnet_params(v, device) for v in tree]
    t = tensor(tree, device, torch.float32)
    return t.permute(3, 2, 0, 1).contiguous() if t.ndim == 4 else t


def population(src: Any, device: DeviceLike = None) -> ClientPopulation:
    """A ``ClientPopulation`` from a mapping or object of (N,) arrays."""
    get = (src.__getitem__ if isinstance(src, Mapping)
           else lambda f: getattr(src, f))
    return ClientPopulation(**{
        f: tensor(get(f), device, _POP_DTYPES.get(f, torch.float32))
        for f in _FIELDS})


def dataset(data: Mapping, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Client data or a test set: ``x`` float32 (NHWC), ``y`` int64."""
    return {"x": tensor(data["x"], device, torch.float32),
            "y": tensor(data["y"], device, torch.int64)}


def optimizer_state(state: Mapping, device: DeviceLike = None) -> Dict:
    """Server optimizer state ``{"m", "v", "t"}`` (or ``{"mu"}``, or
    ``{}``): moment trees like parameters, ``t`` a 0-d CPU int32."""
    out = {}
    for name, v in state.items():
        if name == "t":
            out[name] = torch.as_tensor(np.array(v), dtype=torch.int32)
        else:
            out[name] = resnet_params(v, device)
    return out


def _leaf(x, device: DeviceLike) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return tensor(a.astype(np.float32), device).to(torch.bfloat16)
    return tensor(a, device)


def _tree(tree: Any, device: DeviceLike) -> Any:
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def _unstack(tree: Any, n: int, device: DeviceLike) -> list:
    """A stacked tree (leaves ``(n, ...)``) as ``n`` per-layer trees."""
    flat = _tree(tree, device)

    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        return t[i].clone()
    return [take(flat, i) for i in range(n)]


def lm_params(tree: Mapping, cfg, device: DeviceLike = None) -> Dict:
    """The reference's LM parameter tree (``embed``, ``stages``: a list of
    stacked dicts with ``None`` for ``shared_attn``, ``shared_attn``,
    ``final_norm``, ``lm_head``) as the port's."""
    device = resolve_device(device)
    out = {k: _tree(v, device) for k, v in tree.items() if k != "stages"}
    out["stages"] = [None if kind == "shared_attn" else
                     _unstack(st, n, device)
                     for (kind, n), st in zip(build_stages(cfg),
                                              tree["stages"])]
    return out


def lm_cache(caches: list, cfg, device: DeviceLike = None) -> list:
    """A cache from the reference's ``init_cache`` / ``decode_step`` (one
    entry per stage; runs of layers stacked) as the port's."""
    device = resolve_device(device)
    return [_tree(c, device) if kind == "shared_attn" else
            _unstack(c, n, device)
            for (kind, n), c in zip(build_stages(cfg), caches)]


def lm_optimizer_state(state: Mapping, cfg,
                       device: DeviceLike = None) -> Dict:
    """The reference's optimizer state of an LM (``{"m", "v", "t"}`` of
    ``adamw``, or ``{"mu"}``, or ``{}``): each moment tree as
    :func:`lm_params` (its stacked stage leaves unstacked), ``t`` a 0-d
    CPU int32."""
    return {name: torch.as_tensor(np.array(v), dtype=torch.int32)
            if name == "t" else lm_params(v, cfg, device)
            for name, v in state.items()}
