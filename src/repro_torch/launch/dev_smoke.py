"""Dev smoke: every reduced arch does one train forward/backward and one
decode step, all finite.

The twin of the reference's ``scripts/dev_smoke.py``, on the CUDA card
unless ``--device cpu`` is given; the archs named (default: all ten of
``ARCH_IDS``):

  python -m repro_torch.launch.dev_smoke [--device cpu] [arch ...]

Each arch's reduced config takes random weights from seed 1 and one batch
of 2 x 64 tokens drawn from ``PRNGKey(0)`` (labels the tokens themselves;
a codebook axis for musicgen-large; all-ones ``vision_embeds`` for
internvl2-2b, as the reference's script); then ``loss_fn`` and the
gradient norm of every parameter, and one ``decode_step`` of the first
token at slot 31 of a 32-slot cache. It raises on a non-finite loss,
gradient norm or logit.
"""
from __future__ import annotations

import argparse
import math
from typing import Dict, List, Optional, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch import prng
from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (decode_step, init_cache,
                                            init_params, loss_fn)

B, S = 2, 64


def batch_for(cfg, device) -> Dict[str, torch.Tensor]:
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    toks = prng.randint(prng.PRNGKey(0, device), (B, S) + books, 0,
                        cfg.vocab_size)
    batch = {"tokens": toks, "labels": toks}
    if cfg.frontend == "vision":
        batch["vision_embeds"] = torch.ones((B, cfg.n_patches, cfg.d_model),
                                            device=device)
    return batch


def smoke(arch: str, device) -> Dict:
    """One arch's train forward/backward and decode step: its parameter
    count, loss, gradient norm and decode logits' shape."""
    cfg = get_reduced(arch)
    params = init_params(1, cfg, device=device)
    leaves, spec = tree_flatten(params)
    live = [t.requires_grad_(True) for t in leaves if t is not None]
    batch = batch_for(cfg, device)
    loss, _ = loss_fn(cfg, tree_unflatten(leaves, spec), batch,
                      device=device)
    grads = torch.autograd.grad(loss, live)
    loss = float(loss.detach())
    gnorm = math.sqrt(sum(float(g.float().square().sum()) for g in grads))
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        raise RuntimeError(f"{arch}: loss {loss}, gradient norm {gnorm}")
    with torch.no_grad():
        cache = init_cache(cfg, B, cache_len=32, device=device)
        logits, _ = decode_step(cfg, params, {"tokens":
                                              batch["tokens"][:, :1]},
                                cache, 31, ring=False, device=device)
    if not bool(torch.isfinite(logits.float()).all()):
        raise RuntimeError(f"{arch}: non-finite decode logits")
    return {"arch": arch, "params": sum(t.numel() for t in live),
            "loss": loss, "gnorm": gnorm,
            "decode_logits": tuple(logits.shape)}


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*", default=list(ARCH_IDS))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = []
    for arch in args.archs:
        row = smoke(arch, dev)
        rows.append(row)
        print(f"OK {arch:26s} params={row['params']:>10,} "
              f"loss={row['loss']:.4f} gnorm={row['gnorm']:.3f} "
              f"dec_logits={row['decode_logits']}", flush=True)
    return rows


if __name__ == "__main__":
    main()
