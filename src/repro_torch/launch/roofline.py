"""Roofline analysis of a traced step (``launch/dryrun.py``).

The port's ``repro/launch/roofline.py``. Three terms per (arch x shape x
mesh), all in seconds a step per device:

  compute    = dot FLOPs / peak FLOP/s            (the traced step's count)
  memory     = analytic bytes / HBM bytes/s       (analytic_memory_bytes)
  collective = collective bytes / link bytes/s    (0 on one device)

with the rates of a :class:`~repro_torch.configs.base.HardwareSpec`,
:data:`~repro_torch.configs.base.H100_SXM` by default, in place of the
reference's ``TPU_V5E``.

What takes the place of the reference's parts: the port has no HLO, so
``parse_hlo`` and ``shape_bytes`` have no counterpart. :func:`count_step`
runs the step on fake tensors under ``kernels/counting.py::DotFlops``
(``FlopCounterMode`` over the aten operations, each kernel's fake route
reporting its plain version's count) and returns the dot FLOPs, the FLOPs
by operation and the memory a run holds (:class:`StepCount`). So, in
:class:`RooflineReport`, ``dot_flops_per_dev`` takes the place of
``hlo_flops_per_dev``; on one device ``collective_bytes_per_dev`` is 0 and
``collective_by_type`` empty; XLA's own ``cost_analysis`` (``ca_flops``,
``ca_bytes``) is dropped; and ``memory_analysis`` becomes the argument
bytes (parameters, optimizer state, batch and cache, exact from the
specs) and the peak of live bytes (the highest sum of live storages during
the step, the optimizer's update included), ``peak_mem_bytes``.

:func:`model_flops` and :func:`analytic_memory_bytes` are the reference's
formulas, unchanged.
"""
from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import (H100_SXM, HardwareSpec, InputShape,
                                      ModelConfig)
from repro_torch.kernels.counting import DotFlops


# --------------------------------------------------------------- analytics
def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (fwd-only), N = active params."""
    n_active = cfg.param_count(active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode" else 1)
    passes = 6.0 if shape.mode == "train" else 2.0
    return passes * n_active * tokens


def analytic_memory_bytes(cfg: ModelConfig, shape: InputShape,
                          n_devices: int) -> float:
    """Per-device HBM traffic per step (analytic lower-bound model):
    every resident param is read (+ grad/opt r/w for train), the KV/SSM
    cache is read+written (decode), activations ~ 12*B*S*D*L bytes."""
    p_total = cfg.param_count() * 4.0            # f32 master
    if shape.mode == "train":
        weight_traffic = p_total * (1 + 2 + 4)   # read w, write g, opt m/v r/w
    else:
        weight_traffic = cfg.param_count(active_only=shape.mode == "decode") * 2.0
    B = shape.global_batch
    S = shape.seq_len if shape.mode != "decode" else 1
    act = 12.0 * B * S * cfg.d_model * cfg.n_layers * 2.0
    cache = 0.0
    if shape.mode == "decode":
        L = shape.sliding_window or shape.seq_len
        if cfg.attn_kind == "mla":
            per_tok = cfg.kv_lora_rank + cfg.qk_rope_dim
        elif cfg.attn_kind == "gqa":
            per_tok = 2 * cfg.n_kv_heads * cfg.resolved_head_dim
        else:
            per_tok = 0
        n_attn = cfg.n_layers if cfg.arch_type != "hybrid" else \
            cfg.n_layers // max(cfg.attn_every, 1)
        cache = B * L * per_tok * n_attn * 2.0
        if cfg.arch_type in ("ssm", "hybrid"):
            cache += B * cfg.d_inner * max(cfg.ssm_state, 1) * cfg.n_layers * 4.0
    return (weight_traffic + act + cache) / n_devices


# ------------------------------------------------------------ the counting
def storages(tree: Any) -> Dict[int, torch.UntypedStorage]:
    """The distinct storages of the tensors in ``tree``: views count once."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[id(st)] = st
    return out


class LiveBytes(TorchDispatchMode):
    """The bytes of live storages while it is open, and their peak: each
    storage an operation outputs is counted once, from its first
    appearance until it is freed (a weak reference's callback), so views
    count once. Storages made before it opened count only as given to
    :meth:`hold` (a step's arguments)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, Tuple[weakref.ref, int]] = {}
        self._lock = threading.Lock()

    def _freed(self, key: int, _ref) -> None:
        with self._lock:
            entry = self._refs.pop(key, None)
            if entry is not None:
                self.live -= entry[1]

    def _track(self, st: torch.UntypedStorage) -> None:
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()
        with self._lock:
            self._refs[key] = (weakref.ref(
                st, lambda r, key=key: self._freed(key, r)), n)
            self.live += n
            self.peak = max(self.peak, self.live)

    def hold(self, tree: Any) -> int:
        """Count ``tree``'s storages as live; returns their bytes."""
        before = self.live
        for st in storages(tree).values():
            self._track(st)
        return self.live - before

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for st in storages(out).values():
            self._track(st)
        return out


@dataclass
class StepCount:
    """What :func:`count_step` found: the dot FLOPs, the FLOPs by aten
    operation and by kernel, the bytes of the arguments and the peak of
    live bytes during the step (arguments included), and the seconds the
    trace took."""
    dot_flops: float
    flops_by_op: Dict[str, float]
    argument_bytes: int
    peak_live_bytes: int
    trace_s: float


def count_step(fn: Callable, *args) -> StepCount:
    """Run ``fn(*args)`` (on fake tensors, inside the caller's
    ``FakeTensorMode``) under :class:`~repro_torch.kernels.counting.DotFlops`
    and :class:`LiveBytes`; nothing is allocated or launched."""
    t0 = time.perf_counter()
    with DotFlops() as flops, LiveBytes() as mem:
        arg_bytes = mem.hold(args)
        out = fn(*args)
        del out
    return StepCount(dot_flops=float(flops.total),
                     flops_by_op={k: float(v) for k, v in
                                  sorted(flops.by_op.items())},
                     argument_bytes=arg_bytes, peak_live_bytes=mem.peak,
                     trace_s=time.perf_counter() - t0)


# ----------------------------------------------------------------- report
@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: Tuple[int, ...]
    n_devices: int
    dot_flops_per_dev: float
    analytic_bytes_per_dev: float
    collective_bytes_per_dev: float
    collective_by_type: Dict[str, float]
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops_total: float
    useful_ratio: float
    peak_mem_bytes: Optional[float] = None
    argument_bytes: Optional[float] = None
    flops_by_op: Dict[str, float] = field(default_factory=dict)

    def row(self) -> str:
        return (f"{self.arch},{self.shape},{'x'.join(map(str, self.mesh))},"
                f"{self.t_compute:.6e},{self.t_memory:.6e},"
                f"{self.t_collective:.6e},{self.dominant},"
                f"{self.useful_ratio:.3f}")


def analyze(cfg: ModelConfig, shape: InputShape, mesh_shape: Tuple[int, ...],
            dot_flops: float, memory: Optional[StepCount] = None,
            hw: HardwareSpec = H100_SXM) -> RooflineReport:
    """The three terms from a step's per-device dot FLOPs (``dot_flops``,
    :func:`count_step`'s) and ``hw``'s rates; ``memory`` (a
    :class:`StepCount`) gives the argument and peak bytes."""
    n_dev = 1
    for s in mesh_shape:
        n_dev *= s
    flops_dev = float(dot_flops)
    bytes_dev = analytic_memory_bytes(cfg, shape, n_dev)
    coll_dev = 0.0

    t_comp = flops_dev / hw.peak_flops
    t_mem = bytes_dev / hw.hbm_bw
    t_coll = coll_dev / hw.ici_bw
    dominant = max((("compute", t_comp), ("memory", t_mem),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape)
    useful = mf / max(flops_dev * n_dev, 1.0)
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=tuple(mesh_shape),
        n_devices=n_dev, dot_flops_per_dev=flops_dev,
        analytic_bytes_per_dev=bytes_dev, collective_bytes_per_dev=coll_dev,
        collective_by_type={}, t_compute=t_comp, t_memory=t_mem,
        t_collective=t_coll, dominant=dominant, model_flops_total=mf,
        useful_ratio=useful,
        peak_mem_bytes=None if memory is None else memory.peak_live_bytes,
        argument_bytes=None if memory is None else memory.argument_bytes,
        flops_by_op={} if memory is None else dict(memory.flops_by_op))
