"""Deterministic synthetic datasets, in PyTorch.

1. Speech-commands-like classification (the paper's workload): 35 keyword
   classes, 1x32x32 mel-spectrogram-like inputs. Each class is a fixed
   smooth random prototype; samples are prototype + noise, so the small
   CNN genuinely learns. Same keys and same draws as the reference; the
   normal draws differ from it only in ``erfinv``'s last bits.

2. LM token streams: an order-1 Markov chain over the vocabulary (the next
   token depends on the previous token's bucket), equal to the
   reference's streams bit for bit.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch import prng


def class_prototypes(key: torch.Tensor, n_classes: int, hw: int,
                     channels: int = 1) -> torch.Tensor:
    """Smooth random prototype per class (low-frequency Fourier mix):
    ``(n_classes, hw, hw, channels)``."""
    k1, k2 = prng.split(key)
    n_freq = 6
    coef = prng.normal(k1, (n_classes, n_freq, n_freq, channels))
    phase = prng.uniform(k2, (n_classes, n_freq, n_freq, 2)) \
        * torch.tensor(2 * math.pi, dtype=torch.float32, device=key.device)
    xs = torch.linspace(0, 1, hw, device=key.device)
    two_pi = torch.tensor(2 * math.pi, dtype=torch.float32, device=key.device)
    out = torch.zeros((n_classes, hw, hw, channels), device=key.device)
    for fx in range(n_freq):
        for fy in range(n_freq):
            wave = (torch.sin(two_pi * (fx + 1) * xs[None, :, None]
                              + phase[:, fx, fy, 0][:, None, None])
                    * torch.sin(two_pi * (fy + 1) * xs[None, None, :]
                                + phase[:, fx, fy, 1][:, None, None]))
            out = out + coef[:, fx, fy, None, None, :] * wave[..., None]
    return out / n_freq


def make_classification_set(key: torch.Tensor, labels: torch.Tensor,
                            prototypes: torch.Tensor,
                            noise: float = 0.8) -> torch.Tensor:
    """labels ``(..., M)`` -> x ``(..., M, H, W, C)``: prototype + gaussian
    noise. ``key`` may carry leading batch dimensions matching ``labels``'s
    (one noise key per client)."""
    x = prototypes[labels]
    lead = key.shape[:-1]
    z = prng.normal(key, x.shape[len(lead):])
    return (x + noise * z).to(torch.float32)


def sample_speech_like(key: torch.Tensor, n_samples: int, n_classes: int = 35,
                       hw: int = 32, noise: float = 0.8,
                       prototypes=None) -> Dict[str, torch.Tensor]:
    """``{"x": (n, hw, hw, 1) f32, "y": (n,) int64}``: uniform labels and
    prototype + noise inputs, on ``key``'s device. Labels equal the
    reference's bit for bit; x goes through ``normal``."""
    _, kl, kn = prng.split(key, 3)
    if prototypes is None:
        prototypes = class_prototypes(prng.PRNGKey(7, key.device), n_classes,
                                      hw)
    y = prng.randint(kl, (n_samples,), 0, n_classes)
    return {"x": make_classification_set(kn, y, prototypes, noise), "y": y}


def markov_lm_tokens(key: torch.Tensor, batch: int, seq_len: int,
                     vocab: int, order_vocab: int = 64) -> torch.Tensor:
    """Learnable token stream ``(batch, seq_len)`` int64 on ``key``'s
    device: the next token depends on the previous token's bucket.

    The transition table is fixed (drawn from ``PRNGKey(42)``), so
    successive batches sample the same stationary process. As in the
    reference, the first token is drawn from ``key`` itself, and ``key`` is
    then split into one key a step, whose draw ``randint(k, (batch,), 0,
    8)`` picks the column of the table. The draws of all steps are made at
    once; the chain of table lookups runs on the host (``seq_len`` tiny
    gathers, which would be as many kernel launches on a card)."""
    trans = prng.randint(prng.PRNGKey(42, key.device), (order_vocab, 8), 0,
                         vocab)
    choice = prng.randint(prng.split(key, seq_len), (batch,), 0, 8)
    tok = prng.randint(key, (batch,), 0, vocab).cpu()
    trans, choice = trans.cpu(), choice.cpu()
    out = torch.empty((seq_len, batch), dtype=torch.int64)
    for t in range(seq_len):
        tok = trans[tok % order_vocab, choice[t]]
        out[t] = tok
    return out.T.contiguous().to(key.device)


def lm_batch(key: torch.Tensor, cfg, batch: int,
             seq_len: int) -> Dict[str, torch.Tensor]:
    """Train batch ``{"tokens", "labels"}``, each ``(batch, seq_len)``
    int64 (labels are the next-token shift), on ``key``'s device, for any
    architecture, as the reference's:

    - vision frontend: ``seq_len - cfg.n_patches`` text tokens a row from
      ``key`` (the patches fill the rest of ``seq_len``) and
      ``vision_embeds`` ``0.02 * normal(fold_in(key, 1))``
      (batch, n_patches, d_model) f32 (``normal``'s caveat: close to the
      reference's, not bit for bit);
    - codebooks: one stream a key of ``split(key, n_codebooks)``, stacked
      on the last axis: tokens and labels ``(batch, seq_len, ncb)``.

    The token streams equal the reference's bit for bit."""
    if cfg.frontend == "vision":
        text_len = seq_len - cfg.n_patches
        toks = markov_lm_tokens(key, batch, text_len + 1, cfg.vocab_size)
        ve = prng.normal(prng.fold_in(key, 1),
                         (batch, cfg.n_patches, cfg.d_model))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                "vision_embeds": 0.02 * ve}
    if cfg.n_codebooks > 1:
        toks = torch.stack([markov_lm_tokens(k, batch, seq_len + 1,
                                             cfg.vocab_size)
                            for k in prng.split(key, cfg.n_codebooks)],
                           dim=-1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    toks = markov_lm_tokens(key, batch, seq_len + 1, cfg.vocab_size)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
