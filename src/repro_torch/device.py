"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

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


@contextlib.contextmanager
def deterministic_float32(device: torch.device) -> Iterator[None]:
    """On a CUDA ``device``, cuDNN's deterministic float32 algorithms for
    the block (TF32 off for convolutions and matmuls), the flags restored
    after; elsewhere nothing. cuDNN's default algorithms sum with atomics
    in an order that changes from run to run, and training amplifies the
    difference past a parity check's tolerance."""
    if device.type != "cuda":
        yield
        return
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
