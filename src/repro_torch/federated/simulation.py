"""Round simulation: timing, energy, battery, dropouts (sync host subset).

Mirrors the reference's FedScale-style simulator: a round's wall time is
the slowest successful participant's download + compute + upload latency;
battery is debited with the Sec. 4.2 energy models; a client whose battery
hits zero mid-round drops out (the paper's central failure mode); idle
devices drain at the idle/busy mix rate over the round's wall time.

:func:`simulate_round_device` is the tensor core over a selection mask;
:func:`simulate_round` is the host facade over an index list, with the
fleet energy-budget gate. Fault injection is not ported yet (ROADMAP.md,
queue 1 item 9): ``faults`` must be ``None``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.clients import ClientPopulation, round_times
from repro_torch.core.energy import EnergyModel, pct_to_joules
from repro_torch.numerics import f32


@dataclass
class RoundOutcome:
    selected: np.ndarray          # (K,) indices
    succeeded: np.ndarray         # (K,) bool: finished with battery left
    durations: np.ndarray         # (K,) seconds (per selected client)
    round_duration: float         # wall seconds for the round
    new_dropouts: int             # clients that ran out of battery this round
    energy_spent_pct: float       # total battery % spent by participants
    retries: int = 0              # upload re-attempts (faults: not ported)
    corrupt: Optional[np.ndarray] = None  # (K,) bool: delta is poisoned
    energy_spent_j: float = 0.0   # joules debited by this round's cohort
    admitted: bool = True         # False when the budget gate refused it
    spent_after_j: float = 0.0    # cumulative fleet joules after this round


class DeviceRoundOutcome(NamedTuple):
    """Per-round tensor outputs (full-population masks)."""

    sel_mask: torch.Tensor        # (N,) bool, selected this round
    succeeded: torch.Tensor       # (N,) bool, selected & finished
    durations: torch.Tensor       # (N,) f32, per-client total round seconds
    cost_pct: torch.Tensor        # (N,) f32, battery % a participant pays
    round_duration: torch.Tensor  # f32 scalar, wall seconds
    new_dropouts: torch.Tensor    # int scalar
    energy_spent_pct: torch.Tensor  # f32 scalar
    energy_spent_j: torch.Tensor  # f32 scalar, cohort joules this round


class BudgetLedger(NamedTuple):
    """Fleet-wide cumulative-energy ledger: ``spent_j`` accumulates the
    joules of every admitted cohort (one float32 chain); ``exhausted_round``
    is the first 1-based round the gate refused a cohort (0 = never)."""

    spent_j: torch.Tensor
    exhausted_round: torch.Tensor

    @classmethod
    def create(cls, device=None) -> "BudgetLedger":
        return cls(torch.zeros((), dtype=torch.float32, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def _no_faults(faults) -> None:
    if faults is not None:
        raise NotImplementedError(
            "fault injection is not ported yet (ROADMAP.md, queue 1 item 9)")


def cohort_energy_j(pop: ClientPopulation, sel_mask: torch.Tensor,
                    cost_pct: torch.Tensor) -> torch.Tensor:
    """Joules the masked cohort would debit at ``cost_pct`` battery-%: the
    one expression shared by the budget gate and the debit, so "spent
    never exceeds budget" is exact."""
    j = pct_to_joules(pop.category, cost_pct)
    return torch.where(sel_mask, j, torch.zeros_like(j)).sum()


def budget_gate(sel_mask: torch.Tensor, round_j: torch.Tensor,
                ledger: BudgetLedger, energy_budget_j: Optional[float],
                rnd) -> Tuple[torch.Tensor, torch.Tensor, BudgetLedger]:
    """All-or-nothing cohort admission against the remaining budget:
    ``(sel_mask', admit, ledger')``. Identity when ``energy_budget_j`` is
    None."""
    if energy_budget_j is None:
        return sel_mask, torch.ones((), dtype=torch.bool,
                                    device=sel_mask.device), ledger
    admit = ledger.spent_j + round_j <= f32(energy_budget_j, round_j)
    refused = sel_mask.any() & ~admit
    exhausted = torch.where((ledger.exhausted_round == 0) & refused,
                            torch.as_tensor(rnd, dtype=torch.int32,
                                            device=sel_mask.device),
                            ledger.exhausted_round)
    return sel_mask & admit, admit, ledger._replace(exhausted_round=exhausted)


def _round_cost(pop: ClientPopulation, energy_model: EnergyModel,
                model_bytes: float, local_steps: int, batch_size: int,
                up_bytes: Optional[float]):
    """Per-client round time and battery cost, one computation for both."""
    t = round_times(pop, model_bytes, local_steps, batch_size, up_bytes)
    cost = energy_model.round_cost_pct(pop.category, pop.network,
                                       t["comp"], t["down"], t["up"])
    return t["total"], cost


def predicted_round_cost_pct(pop: ClientPopulation, energy_model: EnergyModel,
                             model_bytes: float, local_steps: int,
                             batch_size: int,
                             up_bytes: float = None) -> torch.Tensor:
    """battery_used(i) for Eq. 1's power(i): the same model as the debit."""
    return _round_cost(pop, energy_model, model_bytes, local_steps,
                       batch_size, up_bytes)[1]


def round_cost_table(pop: ClientPopulation, energy_model: EnergyModel,
                     model_bytes: float, local_steps: int, batch_size: int,
                     up_bytes: Optional[float] = None):
    """The round-invariant per-client ``(round time, battery cost)`` table;
    both depend only on fields that never change during a run."""
    return _round_cost(pop, energy_model, float(model_bytes),
                       int(local_steps), int(batch_size),
                       None if up_bytes is None else float(up_bytes))


def simulate_round_device(pop: ClientPopulation, sel_mask: torch.Tensor,
                          t_total: torch.Tensor, cost: torch.Tensor,
                          rnd, energy_model: EnergyModel,
                          deadline_s: Optional[float] = None,
                          ) -> Tuple[ClientPopulation, DeviceRoundOutcome]:
    """Round state update over a (N,) selection mask."""
    zero = torch.zeros_like(cost)
    neg_inf = f32(float("-inf"), cost)
    battery_after = pop.battery_pct - torch.where(sel_mask, cost, zero)
    ran_out = sel_mask & (battery_after <= 0.0)
    # `is not None`: deadline_s=0.0 is a real deadline nobody can meet
    if deadline_s is not None:
        missed_deadline = sel_mask & (t_total > deadline_s)
    else:
        missed_deadline = torch.zeros_like(sel_mask)
    succeeded = sel_mask & ~ran_out & ~missed_deadline

    # round wall time: slowest successful participant (or deadline)
    any_sel = sel_mask.any()
    max_succ = torch.where(succeeded, t_total, neg_inf).max()
    max_sel = torch.where(sel_mask, t_total, neg_inf).max()
    fallback = f32(deadline_s, cost) if deadline_s is not None else max_sel
    duration = torch.where(succeeded.any(), max_succ, fallback)
    if deadline_s is not None:
        duration = torch.minimum(duration, f32(deadline_s, cost))
    duration = torch.where(any_sel, duration, zero.new_zeros(()))

    # unselected (and dropped-out mid-round) devices drain at idle rate
    idle = pop.battery_pct - energy_model.idle_cost_pct(pop.category,
                                                        duration)
    battery_new = torch.clamp(torch.where(sel_mask, battery_after, idle),
                              0.0, 100.0)

    was_dropped = pop.dropped
    dropped_new = was_dropped | (battery_new <= 0.0)
    new_dropouts = (dropped_new & ~was_dropped).sum().to(torch.int32)

    rnd_t = torch.as_tensor(rnd, dtype=torch.int32, device=cost.device)
    new_pop = pop.replace(
        battery_pct=battery_new,
        dropped=dropped_new,
        explored=pop.explored | sel_mask,
        last_duration=torch.where(sel_mask, t_total, pop.last_duration),
        last_round=torch.where(sel_mask, rnd_t, pop.last_round),
        times_selected=pop.times_selected + sel_mask.to(torch.int32),
    )
    outcome = DeviceRoundOutcome(
        sel_mask=sel_mask,
        succeeded=succeeded,
        durations=t_total,
        cost_pct=cost,
        round_duration=duration.to(torch.float32),
        new_dropouts=new_dropouts,
        energy_spent_pct=torch.where(sel_mask, cost, zero).sum(),
        energy_spent_j=cohort_energy_j(pop, sel_mask, cost),
    )
    return new_pop, outcome


def simulate_round(pop: ClientPopulation, selected, energy_model: EnergyModel,
                   model_bytes: float, local_steps: int, batch_size: int,
                   rnd: int, deadline_s: Optional[float] = None,
                   up_bytes: float = None, *, faults=None,
                   energy_budget_j: Optional[float] = None,
                   spent_j: float = 0.0):
    """Returns ``(new_pop, RoundOutcome)``: host facade over the core.

    With ``energy_budget_j`` the fleet budget gate runs first: ``spent_j``
    is the cumulative joules so far (feed back ``outcome.spent_after_j``);
    a cohort whose predicted debit does not fit is refused whole
    (``outcome.admitted`` False, no battery movement)."""
    _no_faults(faults)
    selected = np.asarray(selected)
    dev = pop.device
    sel_mask = torch.zeros(pop.n, dtype=torch.bool, device=dev)
    sel_mask[torch.as_tensor(selected, dtype=torch.long, device=dev)] = True
    ledger = BudgetLedger(
        spent_j=torch.tensor(spent_j, dtype=torch.float32, device=dev),
        exhausted_round=torch.zeros((), dtype=torch.int32, device=dev))
    t_total, cost = _round_cost(pop, energy_model, float(model_bytes),
                                int(local_steps), int(batch_size),
                                None if up_bytes is None else float(up_bytes))
    round_j = cohort_energy_j(pop, sel_mask, cost)
    sel_mask, admit, ledger = budget_gate(sel_mask, round_j, ledger,
                                          energy_budget_j, rnd)
    new_pop, dev_out = simulate_round_device(pop, sel_mask, t_total, cost,
                                             rnd, energy_model, deadline_s)
    spent_after = ledger.spent_j + dev_out.energy_spent_j
    sel = torch.as_tensor(selected, dtype=torch.long, device=dev)
    outcome = RoundOutcome(
        selected=selected,
        succeeded=dev_out.succeeded[sel].cpu().numpy(),
        durations=dev_out.durations[sel].cpu().numpy(),
        round_duration=float(dev_out.round_duration),
        new_dropouts=int(dev_out.new_dropouts),
        energy_spent_pct=float(dev_out.energy_spent_pct),
        retries=0,
        corrupt=np.zeros(len(selected), bool),
        energy_spent_j=float(dev_out.energy_spent_j),
        admitted=bool(admit),
        spent_after_j=float(spent_after),
    )
    return new_pop, outcome
