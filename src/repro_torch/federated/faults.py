"""Deterministic, seed-driven transient client faults, in PyTorch.

On top of the energy physics (battery drain, missed deadlines) a real
fleet sees transient faults:

* **crash-before-upload**: the client finishes local work but its upload
  never lands. With ``max_retries > 0`` it re-attempts; each retry costs
  ``retry_backoff_s`` of wall clock (counted against the round deadline)
  and ``retry_cost_frac`` of the round's energy.
* **straggle**: the round takes ``straggle_factor`` times its clean
  duration.
* **corrupt update**: the upload arrives but its delta is non-finite; the
  server's quarantine must catch it.

Every draw is keyed only on ``(FaultConfig.seed, round, client)`` through
``fold_in``, so the schedule is a pure function of the seed, the same in
every engine and in the reference (the streams are bit-exact threefry).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.numerics import f32, fma

__all__ = ["N_FAULT_STREAMS", "FaultConfig", "FaultDraw", "apply_faults",
           "fault_streams", "faults_for_round"]

#: uniform streams drawn per round: crash, retry, straggle, corrupt
N_FAULT_STREAMS = 4


@dataclass(frozen=True)
class FaultConfig:
    """Transient-fault injection knobs (frozen and hashable)."""
    seed: int = 0
    crash_prob: float = 0.0        # P(upload lost) per selected client/round
    max_retries: int = 0           # re-attempts before the round is lost
    retry_backoff_s: float = 30.0  # wall-clock added per retry
    retry_cost_frac: float = 0.1   # energy surcharge per retry (x round cost)
    straggle_prob: float = 0.0     # P(transient slowdown)
    straggle_factor: float = 3.0   # duration multiplier when straggling
    corrupt_prob: float = 0.0      # P(non-finite update delta)

    def __post_init__(self):
        for name in ("crash_prob", "straggle_prob", "corrupt_prob"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name}={p} is not a probability")
        if self.crash_prob >= 1.0 and self.max_retries > 0:
            raise ValueError("crash_prob=1.0 with retries never terminates")
        if self.max_retries < 0:
            raise ValueError(f"max_retries={self.max_retries} < 0")

    @property
    def active(self) -> bool:
        return (self.crash_prob > 0.0 or self.straggle_prob > 0.0
                or self.corrupt_prob > 0.0)


class FaultDraw(NamedTuple):
    """Per-client fault outcome for one round (all shape ``(n,)``)."""
    fail: torch.Tensor     # bool: upload lost after exhausting retries
    retries: torch.Tensor  # int32: upload re-attempts actually made
    corrupt: torch.Tensor  # bool: delta goes non-finite if the client trains


def fault_streams(fcfg: FaultConfig, rnd, n: int,
                  device) -> Tuple[torch.Tensor, ...]:
    """The round's ``N_FAULT_STREAMS`` uniform streams, each ``(n,)``.
    ``rnd`` is the 1-based round number, a Python int or a 0-d integer
    tensor on ``device`` (read on the device only)."""
    kf = prng.fold_in(prng.PRNGKey(fcfg.seed, device), rnd)
    return tuple(prng.uniform(prng.fold_in(kf, j), (n,))
                 for j in range(N_FAULT_STREAMS))


def _inv_log(p: float) -> float:
    """``1 / log(p)`` as the reference's compiled program holds it: XLA
    folds ``log(p)`` into a float32 constant (correctly rounded) and
    rewrites the division by it as a product with its float32
    reciprocal."""
    log_p = np.float32(np.log(np.float64(np.float32(p))))
    return float(np.float32(1.0) / log_p)


def apply_faults(fcfg: FaultConfig, t_total: torch.Tensor, cost: torch.Tensor,
                 streams: Tuple[torch.Tensor, ...],
                 ) -> Tuple[torch.Tensor, torch.Tensor, FaultDraw]:
    """Fold one round of faults into clean durations and costs: returns
    ``(t_eff, cost_eff, draw)``. Branches on the static config only."""
    u_crash, u_retry, u_straggle, u_corrupt = streams
    n = t_total.shape[0]
    no = torch.zeros(n, dtype=torch.bool, device=t_total.device)
    t_eff, cost_eff = t_total, cost
    fail = no
    retries = torch.zeros(n, dtype=torch.int32, device=t_total.device)

    if fcfg.straggle_prob > 0.0:
        straggle = u_straggle < f32(fcfg.straggle_prob, u_straggle)
        t_eff = torch.where(straggle, t_eff * fcfg.straggle_factor, t_eff)

    if fcfg.crash_prob > 0.0:
        crashed = u_crash < f32(fcfg.crash_prob, u_crash)
        if fcfg.max_retries > 0:
            # inverse-CDF geometric: each re-attempt fails independently
            # with crash_prob, so P(>= j failed retries) = crash_prob**j
            log_u = torch.log(torch.clamp_min(u_retry, f32(1e-12, u_retry)))
            extra = torch.floor(log_u * f32(_inv_log(fcfg.crash_prob), log_u)
                                ).to(torch.int32)
            retries = torch.where(
                crashed, torch.clamp_max(extra + 1, fcfg.max_retries),
                torch.zeros_like(extra))
            fail = crashed & (extra >= fcfg.max_retries)
            r = retries.to(t_eff.dtype)
            # t + r * backoff and 1 + r * frac are each one fused
            # multiply-add in the reference's compiled program
            t_eff = fma(fcfg.retry_backoff_s, r, t_eff)
            cost_eff = cost_eff * fma(fcfg.retry_cost_frac, r,
                                      torch.ones_like(r))
        else:
            fail = crashed

    corrupt = (u_corrupt < f32(fcfg.corrupt_prob, u_corrupt)
               if fcfg.corrupt_prob > 0.0 else no)
    return t_eff, cost_eff, FaultDraw(fail=fail, retries=retries,
                                      corrupt=corrupt)


def faults_for_round(fcfg: Optional[FaultConfig], rnd, t_total: torch.Tensor,
                     cost: torch.Tensor,
                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                Optional[FaultDraw]]:
    """Streams and :func:`apply_faults` in one call; the identity (and
    ``None`` for the draw) when ``fcfg`` is ``None`` or inactive."""
    if fcfg is None or not fcfg.active:
        return t_total, cost, None
    streams = fault_streams(fcfg, rnd, t_total.shape[0], t_total.device)
    return apply_faults(fcfg, t_total, cost, streams)
