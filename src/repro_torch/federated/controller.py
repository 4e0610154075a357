"""Online execution-knob controller for budgeted FL (AutoFL-style).

The fleet budget (``FLConfig.energy_budget_j``) makes the execution knobs
(cohort size ``k``, the aggregation cap ``buffer_size``, the staleness
damping ``staleness_power`` and ``compression_sparsity``) economic
choices: each trades energy a round against accuracy a round. This module
adapts them online with a UCB bandit over a small set of discrete knob
configurations ("arms"), rewarding each pull with the accuracy gained per
joule. The exploration bonus is the client selector's own formula
(:func:`repro_torch.core.selection.ucb_bonus`), and the score mixing is
the selector's affine min-max normalisation, applied to the arm table.

The controller is host-side numpy and tiny (a few floats an arm). It sits
between the rounds of the synchronous host loop
(:func:`repro_torch.federated.server.run_fl` with ``cfg.controller``
set), where the knobs it turns are plain Python values. The fused and
async engines take no controller: their knobs are fixed for the run.

Parity with the reference: ``choose`` computes the bonus in float32 (the
reference's ``ucb_bonus`` runs in float32 with 64-bit types off), scores
in float64 and takes the lowest index on ties. The bonus's ``log`` is
torch's, which can differ from XLA's in the last bit; that moves a pick
only where two arms' scores tie to the last bit.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.selection import ucb_bonus


@dataclass(frozen=True)
class Arm:
    """One knob configuration. ``None`` fields inherit the ``FLConfig``
    value, so an arm only names the knobs it moves."""

    k: Optional[int] = None
    buffer_size: Optional[int] = None
    staleness_power: Optional[float] = None
    compression_sparsity: Optional[float] = None

    def describe(self) -> str:
        set_ = {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}
        return ",".join(f"{k}={v}" for k, v in set_.items()) or "inherit"


@dataclass(frozen=True)
class ControllerConfig:
    """Knobs of the between-rounds UCB controller.

    ``arms`` is the discrete configuration set (a tuple, so the config
    stays hashable); ``ucb_c`` scales the exploration bonus as
    ``SelectorConfig.ucb_c`` scales the clients'; ``reward_floor_j``
    floors the joules of the accuracy-per-energy reward, so a refused
    (zero-energy) round cannot give an infinite reward."""

    arms: Tuple[Arm, ...]
    ucb_c: float = 0.5
    reward_floor_j: float = 1.0

    def __post_init__(self):
        if len(self.arms) < 1:
            raise ValueError("controller needs at least one arm")
        if self.reward_floor_j <= 0.0:
            raise ValueError("reward_floor_j must be > 0 (it floors a "
                             "denominator)")


class UCBController:
    """Deterministic UCB bandit over discrete knob arms.

    No RNG: untried arms are pulled first, in index order, then the arm
    maximising ``normalized_mean_reward * (1 + ucb_bonus(count, t, c))``,
    ties to the lowest index."""

    def __init__(self, cfg: ControllerConfig):
        self.cfg = cfg
        n = len(cfg.arms)
        self.counts = np.zeros(n, dtype=np.int64)
        self.reward_sums = np.zeros(n, dtype=np.float64)

    @property
    def n_arms(self) -> int:
        return len(self.cfg.arms)

    def choose(self, t: int) -> int:
        """Pick the arm for pull number ``t`` (the 1-based round)."""
        untried = np.flatnonzero(self.counts == 0)
        if untried.size:
            return int(untried[0])
        means = self.reward_sums / self.counts
        lo, hi = float(means.min()), float(means.max())
        span = hi - lo
        norm = (means - lo) / span if span > 0.0 else np.ones_like(means)
        bonus = ucb_bonus(torch.as_tensor(self.counts, dtype=torch.float32),
                          t, self.cfg.ucb_c).numpy().astype(np.float64)
        score = norm * (1.0 + bonus)
        return int(np.argmax(score))     # ties: lowest index

    def update(self, arm: int, acc_delta: float, energy_j: float) -> float:
        """Credit the pulled arm with accuracy gain per joule. Returns the
        reward recorded."""
        reward = float(acc_delta) / max(float(energy_j),
                                        self.cfg.reward_floor_j)
        self.counts[arm] += 1
        self.reward_sums[arm] += reward
        return reward

    # the host loop snapshots this beside its Python-side history
    def state_dict(self) -> Dict[str, List[float]]:
        return {"counts": [int(c) for c in self.counts],
                "reward_sums": [float(s) for s in self.reward_sums]}

    def load_state(self, state: Dict[str, List[float]]) -> None:
        counts = np.asarray(state["counts"], dtype=np.int64)
        sums = np.asarray(state["reward_sums"], dtype=np.float64)
        if counts.shape != self.counts.shape:
            raise ValueError(
                f"controller snapshot has {counts.shape[0]} arms, "
                f"config has {self.n_arms}")
        self.counts, self.reward_sums = counts, sums


def arm_knobs(cfg_value, arm_value):
    """One knob: the arm's setting, or the config's when the arm inherits
    (``is not None``: 0 and 0.0 are settings, not "inherit")."""
    return cfg_value if arm_value is None else arm_value
