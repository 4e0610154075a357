"""Round steps run many times over one carry: eagerly on the CPU, replayed
from CUDA graphs on the card.

The fused engines write a round as a pure function ``fn(carry, ctr) ->
(new_carry, outs)``: ``carry`` a tree of tensors (params, optimizer
state, population, selector state, RNG keys, ledger), ``ctr`` a 0-d int64
device tensor holding the 0-based round index, ``outs`` a dict of
per-round tensors. :class:`StepGraphs` keeps the carry in static tensors
updated in place, and each output in a preallocated ``(rounds, ...)``
trajectory buffer at row ``ctr``; nothing is read on the host inside a
round. A step may also write a carry tensor in place and return that
same tensor (the async engine's snapshot ring, too large to copy each
step). On the CPU a step runs eagerly. On CUDA its first call runs it
once on a side stream, on a copy of the carry (a warm-up whose results
are discarded: it initialises libraries, kernel attributes and cached
constants outside capture), captures it into a ``torch.cuda.CUDAGraph``
and replays it;
every later call is a replay. A failed capture raises: there is no eager
fallback on the card. The warm-up's kernel launches are real and count
in ``kernels.ops.LAUNCHES``; the capture's launch nothing, and each replay
adds them.

The first run of each step logs one INFO record to this module's logger,
"Capturing <name> with carry shapes and types [...]": the capture on the
card, the first eager run on the CPU. Later runs log nothing, so one
record a step a run, whatever the segments, is the contract that
``analysis.runtime.retrace_guard`` checks on both devices.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Set, Tuple

import numpy as np
import torch

from repro_torch.analysis.runtime import device_get
from repro_torch.checkpoint import tree_flatten, tree_unflatten
from repro_torch.kernels import ops

_log = logging.getLogger(__name__)

StepFn = Callable[[Any, torch.Tensor], Tuple[Any, Dict[str, torch.Tensor]]]


class StepGraphs:
    """Named steps over one static carry (see the module docstring).

    ``add(name, fn, row=0, advance=False)`` registers a step: its outputs
    go to trajectory row ``ctr + row``, and ``advance`` adds one to
    ``ctr`` after it. ``run(name)`` runs it once. ``capture_s`` holds the
    seconds each step's warm-up and capture took, ``launches`` the
    hand-written kernel launches each graph holds."""

    def __init__(self, carry: Any, rounds: int, start: int = 0):
        leaves, self._treedef = tree_flatten(carry)
        self.device = leaves[0].device
        self.static = [leaf.clone() for leaf in leaves]
        self.rounds = rounds
        self.ctr = torch.full((), start, dtype=torch.int64,
                              device=self.device)
        self.traj: Dict[str, torch.Tensor] = {}
        self.capture_s: Dict[str, float] = {}
        self._steps: Dict[str, Tuple[StepFn, int, bool]] = {}
        self._graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self._eager: Set[str] = set()      # steps run eagerly (the CPU)
        # hand-written kernel launches each graph holds (kernels.ops)
        self.launches: Dict[str, Dict[str, int]] = {}

    def carry(self) -> Any:
        """The carry as a tree of the static tensors (live: the next run
        updates them)."""
        return tree_unflatten(self._treedef, self.static)

    def add(self, name: str, fn: StepFn, row: int = 0,
            advance: bool = False) -> None:
        self._steps[name] = (fn, row, advance)

    def _alloc(self, outs: Dict[str, torch.Tensor]) -> None:
        for key, v in outs.items():
            if key not in self.traj:
                self.traj[key] = torch.zeros((self.rounds, *v.shape),
                                             dtype=v.dtype, device=v.device)

    def _body(self, name: str) -> None:
        fn, row, advance = self._steps[name]
        new, outs = fn(self.carry(), self.ctr)
        new_leaves, _ = tree_flatten(new)
        for s, n in zip(self.static, new_leaves):
            if n is not s:
                s.copy_(n)
        self._alloc(outs)        # on CUDA: done by the warm-up already
        at = (self.ctr + row).reshape(1)
        for key, v in outs.items():
            self.traj[key].index_copy_(0, at, v.reshape(1, *v.shape))
        if advance:
            self.ctr += 1

    def _log_capture(self, name: str) -> None:
        """The step's one INFO record, from the carry's shapes and dtypes
        alone (it reads nothing from the device)."""
        if _log.isEnabledFor(logging.INFO):
            specs = ", ".join(
                f"{str(s.dtype).removeprefix('torch.')}"
                f"[{','.join(map(str, s.shape))}]" for s in self.static)
            _log.info("Capturing %s with carry shapes and types [%s]", name,
                      specs)

    def run(self, name: str) -> None:
        if self.device.type != "cuda":
            if name not in self._eager:
                self._eager.add(name)
                self._log_capture(name)
            self._body(name)
            return
        if name not in self._graphs:
            self._capture(name)
        self._graphs[name].replay()
        for kernel, n in self.launches[name].items():
            ops.LAUNCHES[kernel] += n

    def _capture(self, name: str) -> None:
        self._log_capture(name)
        # the capture waits for the work queued before it: not its cost
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        fn = self._steps[name][0]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            # warm-up, discarded: on a copy, as a step may write its carry
            # in place (the async engine's snapshot ring)
            copy = tree_unflatten(self._treedef,
                                  [s.clone() for s in self.static])
            _, outs = fn(copy, self.ctr)
            self._alloc(outs)
            del outs, copy
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = dict(ops.CAPTURED)
        with torch.cuda.graph(graph):
            self._body(name)
        self._graphs[name] = graph
        self.launches[name] = {k: v - before[k]
                               for k, v in ops.CAPTURED.items()
                               if v != before[k]}
        torch.cuda.synchronize(self.device)
        self.capture_s[name] = time.perf_counter() - t0

    def fetch(self, a: int, b: int) -> Dict[str, np.ndarray]:
        """Trajectory rows ``[a, b)`` on the host: the named read
        (``analysis.runtime.device_get``), one copy a buffer at the end of
        a segment."""
        return device_get({key: v[a:b] for key, v in self.traj.items()})
