"""Small ResNet classifier, the paper's own FL workload, in PyTorch.

A functional ResNet (He et al., CVPR'16) over 1x32x32 mel-like inputs and
35 classes. Parameters are a plain nested dict of tensors with the
reference's structure; convolution weights are OIHW. Public functions take
inputs in the reference's NHWC layout and run NCHW inside. The
convolutions go to ``torch.nn.functional.conv2d`` (cuDNN on the card): the
reference uses XLA convolutions here, not a Pallas kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import prng

Params = Dict[str, Any]


def _conv_init(key: torch.Tensor, k: int, cin: int, cout: int):
    """Drawn in the reference's HWIO order (same stream), stored OIHW."""
    w = (k * k * cin) ** -0.5 * prng.normal(key, (k, k, cin, cout))
    return w.permute(3, 2, 0, 1).contiguous()


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA "SAME" padding: the odd pixel goes after, so a 3x3 stride-2
    conv on an even size pads 0 before and 1 after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """NCHW x OIHW with "SAME" padding."""
    if w.shape[-2:] == (1, 1):
        # a 1x1 stride-s conv reads every s-th pixel and pads nothing:
        # slicing first is the same sum, and it keeps the CPU backward off
        # oneDNN's strided 1x1 path, which crashes in some builds
        return F.conv2d(x[..., ::stride, ::stride], w)
    top, bottom = _same_pads(x.shape[-2], w.shape[-2], stride)
    left, right = _same_pads(x.shape[-1], w.shape[-1], stride)
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def group_norm(x: torch.Tensor, gamma, beta, groups: int = 8,
               eps: float = 1e-5):
    """Group norm over ``min(groups, C)`` contiguous channel groups, with
    the reference's population variance and ``rsqrt``."""
    B, C, H, W = x.shape
    g = min(groups, C)
    xg = x.reshape(B, g, C // g, H, W)
    mu = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = torch.square(xg - mu).mean(dim=(2, 3, 4), keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(B, C, H, W) * gamma[:, None, None] \
        + beta[:, None, None]


def _norm_init(c: int, device) -> Params:
    return {"gamma": torch.ones(c, device=device),
            "beta": torch.zeros(c, device=device)}


def init_resnet(key: torch.Tensor, cfg) -> Params:
    """Random parameters on ``key``'s device, from the reference's key
    schedule (64 subkeys consumed in the same order)."""
    dev = key.device
    w = cfg.width
    widths = [w, 2 * w, 4 * w]
    keys = prng.split(key, 64)
    ki = iter(range(64))
    p: Params = {
        "stem": _conv_init(keys[next(ki)], 3, cfg.in_channels, w),
        "stem_norm": _norm_init(w, dev),
        "stages": [],
    }
    cin = w
    for si, cout in enumerate(widths):
        blocks = []
        for bi in range(cfg.blocks_per_stage):
            stride = 2 if (bi == 0 and si > 0) else 1
            blk = {
                "conv1": _conv_init(keys[next(ki)], 3, cin, cout),
                "norm1": _norm_init(cout, dev),
                "conv2": _conv_init(keys[next(ki)], 3, cout, cout),
                "norm2": _norm_init(cout, dev),
            }
            if cin != cout or stride != 1:
                blk["proj"] = _conv_init(keys[next(ki)], 1, cin, cout)
            blocks.append(blk)
            cin = cout
        p["stages"].append(blocks)
    p["head_w"] = cin ** -0.5 * prng.normal(keys[next(ki)],
                                            (cin, cfg.n_classes))
    p["head_b"] = torch.zeros(cfg.n_classes, device=dev)
    return p


def resnet_forward(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) -> logits (B, n_classes)."""
    h = conv2d(x.permute(0, 3, 1, 2), p["stem"])
    h = F.relu(group_norm(h, **p["stem_norm"]))
    for si, blocks in enumerate(p["stages"]):
        for bi, blk in enumerate(blocks):
            r = h
            s = 2 if (bi == 0 and si > 0) else 1
            h2 = conv2d(h, blk["conv1"], stride=s)
            h2 = F.relu(group_norm(h2, **blk["norm1"]))
            h2 = conv2d(h2, blk["conv2"])
            h2 = group_norm(h2, **blk["norm2"])
            if "proj" in blk:
                r = conv2d(r, blk["proj"], stride=s)
            h = F.relu(r + h2)
    h = h.mean(dim=(2, 3))
    return h @ p["head_w"] + p["head_b"]


def resnet_loss(cfg, p: Params, batch):
    """batch: {x: (B,H,W,C), y: (B,)} -> (mean_loss, per_sample_loss)."""
    logits = resnet_forward(cfg, p, batch["x"])
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"][:, None])[:, 0]
    per_sample = logz - gold
    return per_sample.mean(), per_sample


def resnet_accuracy(cfg, p: Params, batch) -> torch.Tensor:
    logits = resnet_forward(cfg, p, batch["x"])
    return (torch.argmax(logits, -1) == batch["y"]).to(torch.float32).mean()
