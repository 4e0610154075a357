"""PyTorch/CUDA port of the EAFL reproduction (``repro``).

Mirrors the layout of the JAX package module for module. Entry points run
on the CUDA device unless the caller passes ``device="cpu"``; with no CUDA
device and no explicit CPU request they raise (:func:`resolve_device`).
"""
__all__ = ["resolve_device"]


def __getattr__(name):
    # lazy, so a stdlib-only subpackage (``analysis``'s lint) imports
    # without torch
    if name == "resolve_device":
        from repro_torch.device import resolve_device
        return resolve_device
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
