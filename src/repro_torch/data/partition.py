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


def dirichlet_partition(key: torch.Tensor, n_clients: int,
                        samples_per_client: int, n_classes: int = 35,
                        alpha: float = 0.3, hw: int = 32,
                        noise: float = 0.8) -> Dict[str, torch.Tensor]:
    """Dirichlet(alpha) label distribution per client (beyond the paper):
    ``{"x": (N, M, H, W, 1) f32, "y": (N, M) int64}``. The class
    probabilities come from :func:`prng.dirichlet` (gamma variates by
    rejection, which no port can draw bit for bit like the reference's);
    the labels drawn from given probabilities are the reference's, bit
    for bit (:func:`labels_from_probs`)."""
    prototypes = class_prototypes(prng.PRNGKey(7, key.device), n_classes, hw)
    ka, kb, kc = prng.split(key, 3)
    probs = prng.dirichlet(ka, alpha, (n_clients, n_classes))
    y = labels_from_probs(kb, probs, samples_per_client)
    x = make_classification_set(prng.split(kc, n_clients), y, prototypes,
                                noise)
    return {"x": x, "y": y}


def labels_from_probs(key: torch.Tensor, probs: torch.Tensor,
                      samples_per_client: int) -> torch.Tensor:
    """Client i's ``samples_per_client`` labels drawn from ``probs[i]``
    with key ``split(key, N)[i]`` (``jax.random.choice(..., p=probs[i])``
    under vmap): (N, M) int64."""
    keys = prng.split(key, probs.shape[0])
    p_cuml = torch.cumsum(probs.to(torch.float32), dim=-1)
    r = p_cuml[:, -1:] * (1.0 - prng.uniform(keys, (samples_per_client,)))
    return torch.searchsorted(p_cuml.contiguous(), r.contiguous())


def make_test_set(key: torch.Tensor, n_samples: int = 1024,
                  n_classes: int = 35, hw: int = 32,
                  noise: float = 0.8) -> Dict[str, torch.Tensor]:
    prototypes = class_prototypes(prng.PRNGKey(7, key.device), n_classes, hw)
    y = torch.arange(n_samples, device=key.device) % n_classes
    x = make_classification_set(key, y, prototypes, noise)
    return {"x": x, "y": y}
