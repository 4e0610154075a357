"""Non-IID federated data partitioning (paper Sec. 5), in PyTorch.

Each learner gets samples from a random 10% of the labels (4 of 35) with
uniformly sampled data points. Labels equal the reference's bit for bit
(threefry permutation and randint); the noise goes through ``normal``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import prng
from repro_torch.data.synthetic import class_prototypes, make_classification_set

# clients whose noise is drawn at once: bounds the int64 threefry
# temporaries at full width (64 samples of 32x32 per client)
_NOISE_CHUNK = 256


def label_restricted_partition(key: torch.Tensor, n_clients: int,
                               samples_per_client: int, n_classes: int = 35,
                               labels_per_client: int = 4, hw: int = 32,
                               noise: float = 0.8) -> Dict[str, torch.Tensor]:
    """``{"x": (N, M, H, W, 1) f32, "y": (N, M) int64}`` on ``key``'s
    device."""
    prototypes = class_prototypes(prng.PRNGKey(7, key.device), n_classes, hw)
    klab, _, knoise = prng.split(key, 3)
    lab_keys = prng.split(klab, n_clients)
    perm = prng.permutation(lab_keys, n_classes)[:, :labels_per_client]
    picks = prng.randint(prng.fold_in(lab_keys, 1), (samples_per_client,),
                         0, labels_per_client)
    y = torch.gather(perm, 1, picks)
    noise_keys = prng.split(knoise, n_clients)
    x = torch.cat([
        make_classification_set(noise_keys[i:i + _NOISE_CHUNK],
                                y[i:i + _NOISE_CHUNK], prototypes, noise)
        for i in range(0, n_clients, _NOISE_CHUNK)])
    return {"x": x, "y": y}


def make_test_set(key: torch.Tensor, n_samples: int = 1024,
                  n_classes: int = 35, hw: int = 32,
                  noise: float = 0.8) -> Dict[str, torch.Tensor]:
    prototypes = class_prototypes(prng.PRNGKey(7, key.device), n_classes, hw)
    y = torch.arange(n_samples, device=key.device) % n_classes
    x = make_classification_set(key, y, prototypes, noise)
    return {"x": x, "y": y}
