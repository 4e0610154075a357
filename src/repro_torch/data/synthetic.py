"""Deterministic synthetic speech-commands-like data, in PyTorch.

35 keyword classes, 1x32x32 mel-spectrogram-like inputs. Each class is a
fixed smooth random prototype; samples are prototype + noise, so the small
CNN genuinely learns. Same keys and same draws as the reference; the
normal draws differ from it only in ``erfinv``'s last bits.
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
