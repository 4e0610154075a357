"""Serving: prompt replay + token-by-token cached greedy decode.

Runs an architecture's reduced config (``get_reduced``, as the reference
does) with random weights from ``--seed``, on the CUDA card unless
``--device cpu`` is given:

  python -m repro_torch.launch.serve --arch phi3-mini-3.8b --batch 4 \\
      --prompt-len 32 --gen 16 [--window W] [--device cpu]

The prefill replays the prompt through ``decode_step`` token by token, as
the reference's ``serve.py`` does (a production prefill runs
``forward_logits``, ``make_prefill_step``). :func:`generate` holds the loop
so that other callers run it on any config. ``--arch`` takes any of the
ten architectures and defaults to phi3-mini-3.8b, as the reference's.
musicgen-large's prompt and tokens carry its codebooks on a last axis
(greedy choice a codebook). internvl2-2b serves its text tokens only: the
reference's driver draws ``vision_embeds`` that reach no decode step, and
the port draws none.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs import get_reduced
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.transformer import init_cache, init_params


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor          # (B, gen) or (B, gen, ncb) greedy, int64
    prompt_logits: torch.Tensor   # (B, 1, V) or (B, 1, ncb, V) after the
    #                               last prompt token
    prefill_s: float
    decode_s: float


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg, params, prompt: torch.Tensor, gen: int, window: int = 0,
             device: DeviceLike = None) -> Generation:
    """Replay ``prompt`` (B, P), or (B, P, ncb) with codebooks, through
    the cached decode step, then decode ``gen`` tokens greedily (argmax
    over the vocabulary: a token a codebook). ``window > 0`` uses a
    sliding-window ring cache of that length, else a cache of ``P + gen``
    slots."""
    dev = resolve_device(device)
    B, P = prompt.shape[:2]
    L = window or (P + gen)
    ring = bool(window)
    prompt = prompt.to(dev)
    cache = init_cache(cfg, B, cache_len=L, device=dev)
    step = make_serve_step(cfg, ring, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(P):
        logits, cache = step(params, {"tokens": prompt[:, t:t + 1]}, cache, t)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prompt_logits = logits

    t0 = time.perf_counter()
    out_tokens = []
    tok = torch.argmax(logits, dim=-1)
    for t in range(P, P + gen):
        out_tokens.append(tok)
        logits, cache = step(params, {"tokens": tok}, cache, t)
        tok = torch.argmax(logits, dim=-1)
    _sync(dev)
    t_gen = time.perf_counter() - t0
    tokens = (torch.cat(out_tokens, dim=1) if out_tokens else
              torch.zeros((B, 0) + prompt.shape[2:], dtype=torch.int64,
                          device=dev))
    return Generation(tokens, prompt_logits, t_prefill, t_gen)


def main(argv: Optional[list] = None) -> Generation:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--window", type=int, default=0,
                    help=">0: sliding-window ring cache")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    params = init_params(args.seed, cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    B, P = args.batch, args.prompt_len
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    prompt = torch.randint(0, cfg.vocab_size, (B, P) + books, generator=g,
                           device=dev)

    out = generate(cfg, params, prompt, args.gen, args.window, device=dev)
    gen = out.tokens
    print(f"[{args.arch}] batch={B} prompt={P} gen={args.gen} "
          f"window={args.window or 'full'} device={dev}")
    print(f"prefill {out.prefill_s:.2f}s, decode {out.decode_s:.2f}s "
          f"({args.gen * B / max(out.decode_s, 1e-9):.1f} tok/s)")
    print("generated tokens[0]:", gen[0].ravel()[:16].tolist())
    if not (bool(torch.all(gen >= 0)) and bool(torch.all(gen < cfg.vocab_size))):
        raise RuntimeError("generated tokens out of range")
    return out


if __name__ == "__main__":
    main()
