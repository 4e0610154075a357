"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    There is no silent CPU fallback: with no CUDA device and no explicit
    ``device="cpu"`` this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda")


def stream_handle(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``
    (a CUDA device with an index), for a kernel launched through ctypes.
    ``torch.cuda.current_stream(device).cuda_stream`` is the same handle,
    but it builds a Stream object first, which takes a small kernel's
    launch more host time than the kernel itself."""
    return torch._C._cuda_getCurrentRawStream(device.index)
