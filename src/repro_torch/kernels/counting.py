"""The kernels' fake routes and the FLOP counter that hears them.

A dry-run traces a step on ``FakeTensor`` inputs (``launch/dryrun.py``):
shapes, dtypes and devices with no memory behind them. A wrapper of
``kernels/ops.py`` given a fake input takes its kernel's fake route,
whatever the input's device: it launches nothing and builds nothing,
returns fake outputs of the kernel's shapes and dtypes (each module's
``fake``), and reports the dot FLOPs of its work here, by a closed
formula. A real CPU tensor still takes the plain version and a real CUDA
tensor the kernel: nothing else looks at :func:`is_fake`.

The formulas are what ``torch.utils.flop_counter.FlopCounterMode`` counts
over the kernel's plain version (``kernels/ref.py``) at the same shapes:
the products that reach ``mm``/``bmm``, 2 FLOPs a multiply-add. The plain
scans are loops over the sequence; a formula keeps a full-length trace
fast. :class:`DotFlops` is ``FlopCounterMode`` for the aten operations of
a traced step, plus these reports.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import FlopCounterMode

_COUNTERS: List["DotFlops"] = []        # the open counters, innermost last


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a ``FakeTensor``: the wrapper's fake route."""
    return isinstance(t, FakeTensor)


def report(name: str, flops: int) -> None:
    """Add a fake route's dot FLOPs to every open :class:`DotFlops`."""
    for counter in _COUNTERS:
        counter.kernels[name] = counter.kernels.get(name, 0) + int(flops)


class DotFlops:
    """Counts the dot FLOPs of what runs inside it: ``FlopCounterMode``'s
    count of the aten operations (``mm``, ``bmm``, ...) and the kernels'
    reports (:func:`report`). ``by_op`` maps each aten operation's name
    and each kernel's to its FLOPs; ``total`` is their sum."""

    def __init__(self):
        self.kernels: Dict[str, int] = {}
        self._mode = FlopCounterMode(display=False)

    def __enter__(self) -> "DotFlops":
        self._mode.__enter__()
        _COUNTERS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _COUNTERS.remove(self)
        self._mode.__exit__(*exc)

    @property
    def by_op(self) -> Dict[str, int]:
        aten = self._mode.get_flop_counts().get("Global", {})
        out = {str(op): int(n) for op, n in aten.items() if n}
        for name, n in self.kernels.items():
            out[name] = out.get(name, 0) + n
        return out

    @property
    def total(self) -> int:
        return sum(self.by_op.values())


# --------------------------------------------------------------- formulas
def attention_flops(B: int, S: int, H: int, dqk: int, dv: int) -> int:
    """``ref.flash_attention`` (and ``flash_attention_fwd_lse``): the
    scores q k^T over every (query, key) pair, causal or not, and the
    weights times v, per query head (the KV heads repeated)."""
    return 2 * B * H * S * S * (dqk + dv)


def attention_bwd_flops(B: int, S: int, H: int, dqk: int, dv: int) -> int:
    """``ref.flash_attention_bwd``: the scores again, then dV = P^T dO, dP
    = dO V^T, dQ = dS K and dK = dS^T Q."""
    return 2 * B * H * S * S * (3 * dqk + 2 * dv)


def ssd_flops(B: int, S: int, nh: int, hd: int, ds: int) -> int:
    """``ref.ssd_chunk``: y_t = C_t . h_t each step (the state update is
    elementwise)."""
    return 2 * B * S * nh * hd * ds


def ssd_bwd_flops(B: int, S: int, nh: int, hd: int, ds: int) -> int:
    """``ref.ssd_chunk_bwd``: B_t^T g_t, dB_t and dC_t each step."""
    return 6 * B * S * nh * hd * ds


def scan_flops(B: int, S: int, di: int, ds: int) -> int:
    """``ref.selective_scan``: y_t = C_t . h_t each step."""
    return 2 * B * S * di * ds


def scan_bwd_flops(B: int, S: int, di: int, ds: int) -> int:
    """``ref.selective_scan_bwd``: dB_t and dC_t each step."""
    return 4 * B * S * di * ds
