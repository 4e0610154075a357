"""PyTorch/CUDA port of the EAFL reproduction (``repro``).

Mirrors the layout of the JAX package module for module. Entry points run
on the CUDA device unless the caller passes ``device="cpu"``; with no CUDA
device and no explicit CPU request they raise (:func:`resolve_device`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
