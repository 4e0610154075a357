"""Runtime sanitizers for the port's engines.

They complement the static pass with two checks made while a run goes:

* :class:`strict_mode`: a dispatch mode that raises on every implicit
  host read or implicit copy of host data to the device (the fused
  engines' "no host read inside a round" contract, which a CUDA graph
  needs) and, if asked, on a NaN in any floating output of an operator
  that runs eagerly. Engine *set-up* (population, data, model, a
  checkpoint's leaves) may read and copy freely: it says so with
  :func:`setup_transfers`, a window inside strict mode. A read that a
  program means to make is named with :func:`device_get`.

* :func:`retrace_guard`: records the INFO lines ``federated/replay.py``
  logs the first time a :class:`StepGraphs` runs each step ("Capturing
  <name> with carry shapes and types [...]"): the CUDA graph's capture
  on the card, the first eager run on the CPU. A second line for one
  step within one run means the run built its steps twice, and a capture
  costs seconds on the card.

``debug_nans`` note: fault-injected runs (``FaultConfig`` with
``corrupt_prob > 0``) make NaN deltas *by design* (the quarantine masks
them out), so strict mode checks for NaN only when asked; never combine
it with corrupt-fault configurations. While a CUDA graph is being
captured it checks nothing: a capture cannot read the device, and what
it records is checked when the same step runs eagerly (its warm-up). An
operator that only allocates (``torch.empty``) is not checked either:
its bits are whatever the allocator held.
"""
from __future__ import annotations

import contextlib
import logging
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: operators that read a device value on the host, size their output
#: from the data, or make a tensor of host data (``torch.tensor(...)``)
BANNED = ("_local_scalar_dense", "nonzero", "masked_select", "lift_fresh")

#: operators whose output memory is not initialised (its bits are
#: whatever the allocator held): no NaN check of their outputs
UNINITIALISED = ("empty", "empty_like", "empty_strided", "new_empty",
                 "new_empty_strided", "empty_permuted", "resize_",
                 "resize_as_", "set_")

#: the logger ``federated/replay.py`` writes its capture lines to
REPLAY_LOGGER = "repro_torch.federated.replay"

_windows = threading.local()


class HostTransferError(AssertionError):
    """An implicit host read or host-to-device copy under strict mode."""


class NaNError(FloatingPointError):
    """A NaN in an operator's output under ``strict_mode(debug_nans=True)``."""


def _window_open() -> bool:
    return getattr(_windows, "depth", 0) > 0


def _banned(func, args) -> Optional[str]:
    if func.overloadpacket.__name__ in BANNED:
        return f"implicit host transfer: {func}"
    if func is torch.ops.aten.index.Tensor and any(
            i is not None and i.dtype == torch.bool for i in args[1]):
        return "indexing with a bool mask (sizes its output on the host)"
    return None


def _capturing(tensors: List[torch.Tensor]) -> bool:
    return any(t.is_cuda for t in tensors) and \
        torch.cuda.is_current_stream_capturing()


def _check_nans(func, out) -> None:
    flat = out if isinstance(out, (tuple, list)) else (out,)
    floats = [t for t in flat if isinstance(t, torch.Tensor)
              and t.is_floating_point() and t.numel()]
    if not floats or _capturing(floats):
        return
    for t in floats:
        if bool(torch.isnan(t).any()):
            raise NaNError(f"NaN in the output of {func}")


class strict_mode(TorchDispatchMode):
    """Run the enclosed engine calls with implicit transfers refused.

    Any implicit host read (``float(t)``, ``t.item()``, ``bool(t)``, a
    data-sized ``nonzero``/``masked_select``/boolean-mask index) or tensor
    made of host data (``torch.tensor([...])``) raises
    :class:`HostTransferError`, the same on the CPU and on the card.
    Explicit copies (``t.to(device)``, :func:`device_get`) stay legal: the
    point is that every transfer is *named*, not that none happen.
    ``debug_nans=True`` also raises :class:`NaNError` on a NaN in any
    floating output of an operator that runs eagerly (see the module
    docstring for what it does not see)."""

    def __init__(self, *, debug_nans: bool = False):
        super().__init__()
        self.debug_nans = debug_nans

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not _window_open():
            why = _banned(func, args)
            if why is not None:
                raise HostTransferError(why)
        out = func(*args, **(kwargs or {}))
        if self.debug_nans and \
                func.overloadpacket.__name__ not in UNINITIALISED:
            _check_nans(func, out)
        return out


@contextlib.contextmanager
def setup_transfers() -> Iterator[None]:
    """Declare a set-up phase that may read the device and copy host data
    to it.

    Engine entry points wrap their one-time set-up (population, data
    partition, model, checkpoint leaves) in this, so the steady state
    stays guarded under :class:`strict_mode` while set-up is exempt.
    Outside strict mode it changes nothing."""
    _windows.depth = getattr(_windows, "depth", 0) + 1
    try:
        yield
    finally:
        _windows.depth -= 1


def device_get(tree: Any) -> Any:
    """Every tensor of ``tree`` (dicts, lists, tuples, NamedTuples) as a
    numpy array of its own memory: the named device-to-host read, legal
    under :class:`strict_mode` (one copy a tensor, never a host read of a
    scalar)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    if isinstance(tree, dict):
        return {k: device_get(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(device_get(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(device_get(v) for v in tree)
    return tree


def _captured_name(msg: str) -> str:
    """The step name out of a "Capturing <name> with carry shapes and
    types [...]" record."""
    return msg[len("Capturing "):].split(" with carry shapes", 1)[0]


@dataclass
class CompileLog:
    """Capture events observed by :func:`retrace_guard`.

    ``watch`` scopes retrace detection to the named steps (``round``,
    ``eval``, ``agg``); ``watch=None`` watches everything."""

    records: List[str] = field(default_factory=list)
    watch: Optional[frozenset] = None

    def _relevant(self) -> List[str]:
        if self.watch is None:
            return self.records
        return [r for r in self.records
                if _captured_name(r) in self.watch]

    def counts(self) -> Dict[str, int]:
        """Full message -> times captured, for watched steps. A count > 1
        for the *same* message means one step was captured twice over
        the same carry shapes."""
        out: Dict[str, int] = {}
        for r in self._relevant():
            out[r] = out.get(r, 0) + 1
        return out

    def compiles_of(self, name: str) -> int:
        """Total captures of the step named ``name``."""
        return sum(1 for r in self.records if _captured_name(r) == name)

    def retraced(self) -> Dict[str, int]:
        return {msg: n for msg, n in self.counts().items() if n > 1}

    def assert_no_retrace(self) -> None:
        dup = self.retraced()
        if dup:
            detail = "\n".join(f"  x{n}: {msg}" for msg, n in dup.items())
            raise AssertionError(
                f"recapture detected: one step captured more than once:\n"
                f"{detail}")

    def assert_compiled_once(self, *names: str) -> None:
        """Each ``name`` appears in at least one capture record and no
        record of it repeats."""
        self.assert_no_retrace()
        for name in names:
            if self.compiles_of(name) < 1:
                raise AssertionError(
                    f"expected a capture of '{name}' but none was "
                    f"observed; saw: {self.records}")


class _CaptureHandler(logging.Handler):
    """Keeps the "Capturing <name> ..." records of the replay logger."""

    def __init__(self, log: CompileLog):
        super().__init__(level=logging.INFO)
        self.log = log

    def emit(self, record: logging.LogRecord) -> None:
        msg = record.getMessage()
        if msg.startswith("Capturing "):
            self.log.records.append(msg.strip())


@contextlib.contextmanager
def retrace_guard(watch: Optional[Iterable[str]] = None,
                  ) -> Iterator[CompileLog]:
    """Record every step capture inside the block.

    Usage::

        with retrace_guard(watch=("round", "eval")) as log:
            run_fl_scanned(cfg, device="cpu")
        log.assert_compiled_once("round")
    """
    log = CompileLog(watch=None if watch is None else frozenset(watch))
    handler = _CaptureHandler(log)
    logger = logging.getLogger(REPLAY_LOGGER)
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield log
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
