"""Msgpack checkpoints in the reference's EAFLCKPT file format.

A file is a header (magic, u32 format version, u64 payload length, u32
CRC32 of the payload) and one msgpack document. Arrays are stored as
(dtype, shape, raw bytes) of numpy arrays, never as torch pickles, so a
file written by this package loads in the reference and the other way
round. Files are written atomically (tmp + fsync + rename); a truncated,
bit-flipped or foreign file raises :class:`CheckpointError`.

Tensors cross the file boundary in the reference's layouts:

- a 4-d float tensor is a convolution weight, OIHW here and HWIO in the
  reference (and so in the file); a 5-d float tensor is a stack of them
  (the async engines' snapshot ring), SOIHW here and SHWIO there;
- an int64 tensor is a PRNG key (the port holds the two uint32 words of a
  threefry key in int64), stored as uint32.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Any, Dict, Optional, Tuple

import msgpack
import numpy as np
import torch

_ARR = "__arr__"

# File framing: magic, u32 format version, u64 payload length, u32 CRC32
# of the payload. Everything after the header is one msgpack document.
_MAGIC = b"EAFLCKPT"
_VERSION = 1
_HEADER = struct.Struct("<8sIQI")


class CheckpointError(RuntimeError):
    """Checkpoint file is missing, truncated, corrupt, or belongs to an
    incompatible run (metadata mismatch on resume)."""


def to_file(t: torch.Tensor) -> np.ndarray:
    """A tensor as the numpy array the file holds (reference layouts)."""
    a = t.detach().cpu()
    if a.ndim == 4 and a.is_floating_point():
        a = a.permute(2, 3, 1, 0)          # OIHW -> HWIO
    elif a.ndim == 5 and a.is_floating_point():
        a = a.permute(0, 3, 4, 2, 1)       # SOIHW -> SHWIO
    if a.dtype == torch.int64:
        # checked on the host copy: saving mid-run reads nothing from the
        # device but the copy (legal under analysis.runtime.strict_mode)
        n = a.numpy()
        if ((n < 0) | (n > 0xFFFFFFFF)).any():
            raise CheckpointError("an int64 tensor that is not a PRNG key "
                                  "(values outside uint32) has no file form")
        return n.astype(np.uint32)
    return a.contiguous().numpy()


def from_file(a: np.ndarray, dtype: Optional[torch.dtype] = None,
              device=None) -> torch.Tensor:
    """The inverse of :func:`to_file`: ``dtype`` is the tensor's own
    (default: uint32 becomes int64, other dtypes stay)."""
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    t = torch.from_numpy(np.array(a))
    if t.ndim == 4 and t.is_floating_point():
        t = t.permute(3, 2, 0, 1).contiguous()   # HWIO -> OIHW
    elif t.ndim == 5 and t.is_floating_point():
        t = t.permute(0, 4, 3, 1, 2).contiguous()   # SHWIO -> SOIHW
    return t.to(device=device, dtype=dtype)


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        obj = to_file(obj)
    if isinstance(obj, (np.ndarray, np.generic)):
        a = np.asarray(obj)
        return {_ARR: True, "d": a.dtype.str, "s": list(a.shape),
                "b": a.tobytes()}
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return {"__list__": [_pack(v) for v in obj],
                "__tuple__": isinstance(obj, tuple)}
    if obj is None or isinstance(obj, (int, float, str, bool)):
        return obj
    raise TypeError(f"cannot checkpoint {type(obj)}")


def _unpack(obj):
    """Arrays come back as numpy arrays (the file's own form)."""
    if isinstance(obj, dict):
        if obj.get(_ARR):
            a = np.frombuffer(obj["b"], dtype=np.dtype(obj["d"]))
            return a.reshape(obj["s"]).copy()
        if "__list__" in obj:
            vals = [_unpack(v) for v in obj["__list__"]]
            return tuple(vals) if obj.get("__tuple__") else vals
        return {k: _unpack(v) for k, v in obj.items()}
    return obj


def _write_atomic(path: str, payload: bytes) -> None:
    """Write header+payload to ``path`` via tmp + rename; fsync before the
    rename so a crash leaves either the old file or the complete new one."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    header = _HEADER.pack(_MAGIC, _VERSION, len(payload),
                          zlib.crc32(payload) & 0xFFFFFFFF)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_verified(path: str) -> Any:
    """Read ``path``, verify framing + CRC, return the decoded payload."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise CheckpointError(f"cannot read checkpoint {path!r}: {e}") from e
    if len(raw) < _HEADER.size:
        raise CheckpointError(
            f"checkpoint {path!r} is truncated: {len(raw)} bytes is smaller "
            f"than the {_HEADER.size}-byte header")
    magic, version, length, crc = _HEADER.unpack_from(raw)
    if magic != _MAGIC:
        raise CheckpointError(
            f"{path!r} is not a checkpoint file (bad magic {magic!r})")
    if version != _VERSION:
        raise CheckpointError(
            f"checkpoint {path!r} has format version {version}; this build "
            f"reads version {_VERSION}")
    payload = raw[_HEADER.size:]
    if len(payload) != length:
        raise CheckpointError(
            f"checkpoint {path!r} is truncated: header promises {length} "
            f"payload bytes, found {len(payload)}")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise CheckpointError(
            f"checkpoint {path!r} failed its CRC32 integrity check "
            f"(corrupt payload)")
    try:
        return msgpack.unpackb(payload, raw=False, strict_map_key=False)
    except Exception as e:  # malformed msgpack that still passed CRC
        raise CheckpointError(
            f"checkpoint {path!r} payload does not decode: {e}") from e


def _tensors(obj):
    """Numpy arrays of an unpacked tree as CPU tensors (:func:`from_file`)."""
    if isinstance(obj, np.ndarray):
        return from_file(obj)
    if isinstance(obj, dict):
        return {k: _tensors(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tensors(v) for v in obj)
    return obj


def save_checkpoint(path: str, params: Any, step: int = 0,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    payload = {"step": step, "params": _pack(params),
               "extra": _pack(extra or {})}
    _write_atomic(path, msgpack.packb(payload, use_bin_type=True))


def load_checkpoint(path: str) -> Tuple[Any, int, Dict[str, Any]]:
    """``(params, step, extra)``: params as CPU tensors in the port's
    layouts, ``extra`` as stored (numpy arrays)."""
    payload = _read_verified(path)
    if not isinstance(payload, dict) or "params" not in payload:
        raise CheckpointError(
            f"checkpoint {path!r} has no 'params' entry (is it an engine "
            f"checkpoint? use load_engine_checkpoint)")
    return (_tensors(_unpack(payload["params"])), payload["step"],
            _unpack(payload["extra"]))
