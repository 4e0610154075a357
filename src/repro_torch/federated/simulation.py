"""Round simulation: timing, energy, battery, dropouts, and the fused engine.

Mirrors the reference's FedScale-style simulator: a round's wall time is
the slowest successful participant's download + compute + upload latency;
battery is debited with the Sec. 4.2 energy models; a client whose battery
hits zero mid-round drops out (the paper's central failure mode); idle
devices drain at the idle/busy mix rate over the round's wall time.

:func:`simulate_round_device` is the tensor core over a selection mask;
:func:`simulate_round` is the host facade over an index list, with the
fleet energy-budget gate and the fault draws. :func:`make_round_engine`
composes predicted cost, selection and simulation into one step with no
host read, and :func:`run_rounds_scanned` advances it for R rounds,
replayed from a CUDA graph on the card; :func:`run_rounds_sharded` is its
twin over a ``clients`` mesh (``launch/mesh.py``).
:func:`make_async_round_engine`, :func:`run_async_scanned` and
:func:`run_async_sharded` are the buffered-asynchronous (FedBuff) twins:
one step is one server aggregation.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.analysis.runtime import setup_transfers
from repro_torch.checkpoint import (CarryCheckpointer, load_engine_checkpoint,
                                    segment_bounds)
from repro_torch.core.clients import ClientPopulation, round_times
from repro_torch.core.energy import EnergyModel, pct_to_joules
from repro_torch.core.selection import (SelectorConfig, SelectorState,
                                        _device_select, _merge_topk,
                                        _slot_gather, _slot_owner,
                                        _top_k_idx)
from repro_torch.federated.faults import (FaultConfig, FaultDraw,
                                          faults_for_round)
from repro_torch.federated.replay import StepGraphs
from repro_torch.launch.mesh import aany, amax, asum
from repro_torch.numerics import f32, staleness_damping


@dataclass
class RoundOutcome:
    selected: np.ndarray          # (K,) indices
    succeeded: np.ndarray         # (K,) bool: finished with battery left
    durations: np.ndarray         # (K,) seconds (per selected client)
    round_duration: float         # wall seconds for the round
    new_dropouts: int             # clients that ran out of battery this round
    energy_spent_pct: float       # total battery % spent by participants
    retries: int = 0              # upload re-attempts across the cohort
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


def cohort_energy_j(pop: ClientPopulation, sel_mask: torch.Tensor,
                    cost_pct: torch.Tensor, axis=None) -> torch.Tensor:
    """Joules the masked cohort would debit at ``cost_pct`` battery-%: the
    one expression shared by the budget gate and the debit, so "spent
    never exceeds budget" is exact."""
    j = pct_to_joules(pop.category, cost_pct)
    return asum(torch.where(sel_mask, j, torch.zeros_like(j)), axis)


def budget_gate(sel_mask: torch.Tensor, round_j: torch.Tensor,
                ledger: BudgetLedger, energy_budget_j: Optional[float],
                rnd, axis=None,
                ) -> Tuple[torch.Tensor, torch.Tensor, BudgetLedger]:
    """All-or-nothing cohort admission against the remaining budget:
    ``(sel_mask', admit, ledger')``. Identity when ``energy_budget_j`` is
    None. On a mesh the decision is replicated across the shards."""
    if energy_budget_j is None:
        return sel_mask, torch.ones((), dtype=torch.bool,
                                    device=sel_mask.device), ledger
    admit = ledger.spent_j + round_j <= f32(energy_budget_j, round_j)
    refused = aany(sel_mask, axis) & ~admit
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
    both depend only on fields that never change during a run. Elementwise,
    so a sharded population's ``(S, n_loc)`` block gives its shards'
    table (the sharded engines compute it once at set-up)."""
    return _round_cost(pop, energy_model, float(model_bytes),
                       int(local_steps), int(batch_size),
                       None if up_bytes is None else float(up_bytes))


def simulate_round_device(pop: ClientPopulation, sel_mask: torch.Tensor,
                          t_total: torch.Tensor, cost: torch.Tensor,
                          rnd, energy_model: EnergyModel,
                          deadline_s: Optional[float] = None,
                          fail_mask: Optional[torch.Tensor] = None,
                          busy_mask: Optional[torch.Tensor] = None,
                          axis=None,
                          ) -> Tuple[ClientPopulation, DeviceRoundOutcome]:
    """Round state update over a (N,) selection mask.

    With a ``clients`` mesh as ``axis`` the same body runs on a shard
    block (every per-client tensor ``(S, n_loc)``): the per-client updates
    are elementwise, bitwise the unsharded ones, and the scalar reductions
    go over the mesh (max exactly; the summed stats within the last bit).

    ``fail_mask`` marks clients whose upload an injected crash fault lost
    (``federated/faults.py``): they fail the round like a battery death
    (energy is still debited) but drop out only if their battery ran
    dry. ``busy_mask`` marks clients computing through the whole window
    (the async engine's clients still in flight): they pay their round
    cost when they complete, so they do not drain at the idle rate."""
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
    if fail_mask is not None:
        succeeded = succeeded & ~fail_mask

    # round wall time: slowest successful participant (or deadline)
    any_sel = aany(sel_mask, axis)
    max_succ = amax(torch.where(succeeded, t_total, neg_inf), axis)
    max_sel = amax(torch.where(sel_mask, t_total, neg_inf), axis)
    fallback = f32(deadline_s, cost) if deadline_s is not None else max_sel
    duration = torch.where(aany(succeeded, axis), max_succ, fallback)
    if deadline_s is not None:
        duration = torch.minimum(duration, f32(deadline_s, cost))
    duration = torch.where(any_sel, duration, zero.new_zeros(()))

    # unselected (and dropped-out mid-round) devices drain at idle rate
    idle = pop.battery_pct - energy_model.idle_cost_pct(pop.category,
                                                        duration)
    if busy_mask is not None:
        idle = torch.where(busy_mask, pop.battery_pct, idle)
    battery_new = torch.clamp(torch.where(sel_mask, battery_after, idle),
                              0.0, 100.0)

    was_dropped = pop.dropped
    dropped_new = was_dropped | (battery_new <= 0.0)
    new_dropouts = asum(dropped_new & ~was_dropped, axis).to(torch.int32)

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
        energy_spent_pct=asum(torch.where(sel_mask, cost, zero), axis),
        energy_spent_j=cohort_energy_j(pop, sel_mask, cost, axis),
    )
    return new_pop, outcome


def simulate_round(pop: ClientPopulation, selected, energy_model: EnergyModel,
                   model_bytes: float, local_steps: int, batch_size: int,
                   rnd: int, deadline_s: Optional[float] = None,
                   up_bytes: float = None, *,
                   faults: Optional[FaultConfig] = None,
                   energy_budget_j: Optional[float] = None,
                   spent_j: float = 0.0):
    """Returns ``(new_pop, RoundOutcome)``: host facade over the core.

    With ``faults`` the round's fault draws (keyed on ``(faults.seed,
    rnd, client)`` only) are folded in: stragglers and retries lengthen
    ``durations``, retries surcharge the debit, crashed uploads fail the
    round, and ``RoundOutcome.corrupt`` flags the clients whose delta the
    server must quarantine.

    With ``energy_budget_j`` the fleet budget gate runs first, on the
    fault-modified cost: ``spent_j`` is the cumulative joules so far (feed
    back ``outcome.spent_after_j``); a cohort whose debit does not fit is
    refused whole (``outcome.admitted`` False, no battery movement)."""
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
    t_eff, cost_eff, draw = faults_for_round(faults, rnd, t_total, cost)
    round_j = cohort_energy_j(pop, sel_mask, cost_eff)
    sel_mask, admit, ledger = budget_gate(sel_mask, round_j, ledger,
                                          energy_budget_j, rnd)
    new_pop, dev_out = simulate_round_device(
        pop, sel_mask, t_eff, cost_eff, rnd, energy_model, deadline_s,
        fail_mask=None if draw is None else draw.fail)
    spent_after = ledger.spent_j + dev_out.energy_spent_j
    retries, corrupt = _fault_totals(draw, sel_mask)
    sel = torch.as_tensor(selected, dtype=torch.long, device=dev)
    outcome = RoundOutcome(
        selected=selected,
        succeeded=dev_out.succeeded[sel].cpu().numpy(),
        durations=dev_out.durations[sel].cpu().numpy(),
        round_duration=float(dev_out.round_duration),
        new_dropouts=int(dev_out.new_dropouts),
        energy_spent_pct=float(dev_out.energy_spent_pct),
        retries=int(retries),
        corrupt=corrupt[sel].cpu().numpy(),
        energy_spent_j=float(dev_out.energy_spent_j),
        admitted=bool(admit),
        spent_after_j=float(spent_after),
    )
    return new_pop, outcome


def _fault_totals(draw: Optional[FaultDraw], sel_mask: torch.Tensor,
                  axis=None):
    """``(retries, corrupt)``: the cohort's upload re-attempts (int32
    scalar, an exact integer sum over the mesh with one) and the
    per-client poisoned-delta flags; zeros without faults."""
    if draw is None:
        return (torch.zeros((), dtype=torch.int32, device=sel_mask.device),
                torch.zeros_like(sel_mask))
    retries = asum(torch.where(sel_mask, draw.retries,
                               torch.zeros_like(draw.retries)), axis)
    return retries.to(torch.int32), draw.corrupt


# ------------------------------------------------- the fused round engine
# The reference advances selection + simulation for R rounds inside one
# ``lax.scan``. Here the round is one sync-free step over tensors,
# replayed from a CUDA graph on the card (``federated/replay.py``) and run
# eagerly on the CPU; per-round outputs go to preallocated (R, ...)
# buffers fetched once a segment.
#
# One body serves one device and a ``clients`` mesh (``launch/mesh.py``):
# on a mesh the population lives in shard blocks ``(S, n_loc)``,
# selection runs each shard's candidates and a merge, and the battery and
# dropout simulation stays shard-local, with only the (k,) selected slots
# and the round's scalars reassembled by collectives. On a virtual mesh
# the collectives are tensor operations and a round is one CUDA-graph
# replay.

def _round_step(key, sel_state: SelectorState, pop: ClientPopulation,
                t_total: torch.Tensor, cost: torch.Tensor, *,
                sel_cfg: SelectorConfig, energy_model: EnergyModel,
                deadline_s: Optional[float],
                faults: Optional[FaultConfig] = None, axis=None,
                n_real: Optional[int] = None,
                energy_budget_j: Optional[float] = None,
                ledger: Optional[BudgetLedger] = None):
    """The round, selection -> fault draw -> budget gate -> simulation,
    over the clean round times and costs ``t_total``/``cost``. Returns
    ``(pop, sel_state, idx, chosen, DeviceRoundOutcome, retries, corrupt,
    ledger)``. Selection scores on the clean cost (the selector cannot see
    transient faults coming); the gate and the simulation see the
    fault-modified one (``DeviceRoundOutcome.durations``). With ``ledger``
    the budget gate runs on the cohort's joules. On a mesh (``axis``)
    every per-client tensor is a shard block, the fault streams are each
    shard's slice of the prefix-stable population-wide ones, and every
    per-client outcome is bitwise the single-device engine's."""
    idx, chosen, sel_state = _device_select(
        key, sel_cfg, sel_state, pop, cost, cost.device.type == "cuda",
        axis=axis, n_real=n_real)
    sel_mask = slot_mask(idx, chosen, cost.shape[-1], axis)
    # post-selection sel_state.round is the 1-based round number every
    # engine agrees on: the fault draws key off it (on the device)
    t_sim, cost_sim, draw = faults_for_round(faults, sel_state.round,
                                             t_total, cost, axis)
    if ledger is not None:
        round_j = cohort_energy_j(pop, sel_mask, cost_sim, axis)
        sel_mask, _, ledger = budget_gate(sel_mask, round_j, ledger,
                                          energy_budget_j, sel_state.round,
                                          axis)
    pop, dev = simulate_round_device(
        pop, sel_mask, t_sim, cost_sim, sel_state.round, energy_model,
        deadline_s, fail_mask=None if draw is None else draw.fail, axis=axis)
    if ledger is not None:
        ledger = ledger._replace(spent_j=ledger.spent_j + dev.energy_spent_j)
    retries, corrupt = _fault_totals(draw, sel_mask, axis)
    return pop, sel_state, idx, chosen, dev, retries, corrupt, ledger


def make_round_engine(sel_cfg: SelectorConfig, energy_model: EnergyModel,
                      model_bytes: float, local_steps: int, batch_size: int,
                      deadline_s: Optional[float] = None,
                      up_bytes: Optional[float] = None,
                      faults: Optional[FaultConfig] = None,
                      mesh=None, n_real: Optional[int] = None):
    """One fused round step: predicted cost -> selection -> simulation.

    Returns ``step(key, pop, sel_state) -> (pop, sel_state, idx, chosen,
    DeviceRoundOutcome, retries, corrupt)``: ``retries`` (int32 scalar)
    counts the cohort's upload re-attempts and ``corrupt`` (per client,
    bool) flags poisoned deltas, both zero without active ``faults``.
    Nothing in the step reads a value on the host. The top-k kernel runs
    on CUDA and the affine-folded plain route on the CPU, as in
    ``select``. With a ``clients`` ``mesh`` the step takes the population
    in shard blocks, padded from ``n_real`` clients (:func:`_round_step`)."""

    def step(key, pop: ClientPopulation, sel_state: SelectorState):
        t_total, cost = _round_cost(pop, energy_model, model_bytes,
                                    local_steps, batch_size, up_bytes)
        return _round_step(key, sel_state, pop, t_total, cost,
                           sel_cfg=sel_cfg, energy_model=energy_model,
                           deadline_s=deadline_s, faults=faults, axis=mesh,
                           n_real=n_real)[:7]

    return step


def scatter_drop(base: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """``base`` with ``values[i]`` written at ``idx[i]`` where ``keep[i]``:
    the other slots scatter to an extra entry that is cut off (the
    reference's ``.at[where(keep, idx, N)].set(values, mode="drop")``,
    with no host read)."""
    n = base.shape[0]
    padded = torch.cat([base, base.new_zeros((1,) + base.shape[1:])])
    target = torch.where(keep, idx.long(), torch.full_like(idx.long(), n))
    return padded.scatter(0, target, values.to(base.dtype))[:n]


def scatter_drop_rows(base: torch.Tensor, loc: torch.Tensor,
                      keep: torch.Tensor, values: torch.Tensor,
                      ) -> torch.Tensor:
    """:func:`scatter_drop` in each row of a shard block: ``base (S,
    n_loc)`` with ``values[j]`` written in row s at ``loc[s, j]`` where
    ``keep[s, j]`` (``loc``, ``keep``: ``(S, k)``; ``values``: ``(k,)``)."""
    n_loc = base.shape[-1]
    padded = torch.cat([base, base.new_zeros((base.shape[0], 1))], dim=-1)
    target = torch.where(keep, loc, torch.full_like(loc, n_loc))
    return padded.scatter(-1, target, values.to(base.dtype).expand(
        loc.shape))[:, :n_loc]


def slot_mask(idx: torch.Tensor, chosen: torch.Tensor, n: int,
              axis=None) -> torch.Tensor:
    """The per-client mask of the chosen slots' clients: ``(n,)``, or on a
    mesh each local shard's ``(S, n)`` block of it (``n`` = ``n_loc``)."""
    if axis is None:
        return scatter_drop(torch.zeros(n, dtype=torch.bool,
                                        device=idx.device),
                            idx, chosen, torch.ones_like(chosen))
    own, loc = _slot_owner(idx, axis.bases(n, idx.device), n)
    return scatter_drop_rows(
        torch.zeros((axis.local, n), dtype=torch.bool, device=idx.device),
        loc, own & chosen, torch.ones_like(chosen))


def _selection_graphs(step, keys: torch.Tensor, pop: ClientPopulation,
                      st: SelectorState, rounds: int, start: int,
                      mesh=None, n_real: Optional[int] = None,
                      ) -> StepGraphs:
    """The selection engine's round over the carry ``{"pop", "st"}``
    (the twin of the reference's ``_scanned_runner`` and, with a
    ``clients`` ``mesh`` and the population in shard blocks padded from
    ``n_real`` clients, of its ``_sharded_scanned_runner``); round
    ``ctr`` uses key row ``keys[ctr]``."""
    n_real = pop.n if mesh is None else n_real
    n_pad = 0 if mesh is None else mesh.n_padded(n_real) - n_real

    def round_fn(carry, ctr):
        key = keys.index_select(0, ctr.reshape(1))[0]
        pop, st, idx, chosen, dev, retries, corrupt = step(
            key, carry["pop"], carry["st"])
        out = {
            "selected": idx.to(torch.int32),
            "chosen": chosen,
            "succeeded": _slot_gather(dev.succeeded, idx, chosen, mesh) > 0,
            "round_duration": dev.round_duration,
            "new_dropouts": dev.new_dropouts,
            "energy_spent_pct": dev.energy_spent_pct,
            "energy_spent_j": dev.energy_spent_j,
            "mean_battery": asum(pop.battery_pct, mesh) / n_real,
            # pad clients are dead from the start
            "total_dropped": asum(pop.dropped, mesh).to(torch.int32) - n_pad,
            "retries": retries,
            "corrupt": _slot_gather(corrupt, idx, chosen, mesh) > 0,
        }
        return {"pop": pop, "st": st}, out

    graphs = StepGraphs({"pop": pop, "st": st}, rounds, start)
    graphs.add("round", round_fn, advance=True)
    return graphs


# ------------------------------------------------- elastic run plumbing
# Shared by the fused engines: segment the rounds at checkpoint
# boundaries, snapshot the full carry atomically, splice trajectory parts
# back together, and identify checkpoints so a resume refuses a snapshot
# of another run. Each engine replays an explicit prefix-stable key array
# (or carries its RNG chain), so resuming from a round-r snapshot is
# bitwise identical to the uninterrupted run.

def _engine_meta(family: str, sel_cfg: SelectorConfig, n: int, rounds: int,
                 deadline_s, faults: Optional[FaultConfig],
                 **extra) -> Dict[str, Any]:
    return {
        "family": family,
        "n_clients": int(n),
        "rounds": int(rounds),
        "kind": sel_cfg.kind,
        "k": int(sel_cfg.k),
        "deadline_s": None if deadline_s is None else float(deadline_s),
        "faults": None if faults is None else dataclasses.asdict(faults),
        **extra,
    }


def _concat_traj(parts: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Concatenate per-segment trajectory dicts along the round axis."""
    if len(parts) == 1:
        return dict(parts[0])
    return {k: np.concatenate([np.asarray(p[k]) for p in parts], axis=0)
            for k in parts[0]}


def _make_checkpointer(checkpoint_path: Optional[str],
                       checkpoint_every: Optional[int], rounds: int,
                       meta: Dict[str, Any]):
    """Validate the elastic knobs into a CarryCheckpointer (or None);
    ``checkpoint_path`` alone means a final snapshot only."""
    if checkpoint_every is not None and not checkpoint_path:
        raise ValueError("checkpoint_every is set but checkpoint_path is "
                         "not: there is nowhere to write snapshots")
    if not checkpoint_path:
        return None
    every = checkpoint_every if checkpoint_every is not None else rounds
    return CarryCheckpointer(checkpoint_path, every, rounds, meta)


def _run_selection_engine(key: torch.Tensor, sel_cfg: SelectorConfig,
                          pop: ClientPopulation, sel_state: SelectorState,
                          energy_model: EnergyModel, model_bytes: float,
                          local_steps: int, batch_size: int, rounds: int,
                          deadline_s: Optional[float],
                          up_bytes: Optional[float],
                          faults: Optional[FaultConfig],
                          checkpoint_every: Optional[int],
                          checkpoint_path: Optional[str],
                          resume_from: Optional[str], mesh=None):
    """The selection engine's segment, checkpoint and resume loop, on one
    device or over a ``clients`` ``mesh`` (the population padded and laid
    out in shard blocks for the run, and trimmed to its real clients in
    snapshots and in the result, on every process; rank 0 of a
    process-group mesh writes the snapshots)."""
    from repro_torch.launch.sharding import population_sharding

    n_real = pop.n
    meta = _engine_meta("sync", sel_cfg, n_real, rounds, deadline_s, faults)
    start, parts = 0, []
    with setup_transfers():     # one-time host-to-device materialisation
        keys = prng.split(key, rounds)
        st = sel_state.canonical(pop.device)
        if resume_from is not None:
            start, state, data, _ = load_engine_checkpoint(
                resume_from, {"pop": pop, "st": st}, expect_meta=meta)
            pop, st = state["pop"], state["st"]
            if data.get("traj"):
                parts.append(data["traj"])
        if mesh is not None:
            pop = population_sharding(mesh)(pop)
        step = make_round_engine(
            sel_cfg, energy_model, float(model_bytes), int(local_steps),
            int(batch_size), None if deadline_s is None else float(deadline_s),
            None if up_bytes is None else float(up_bytes), faults, mesh,
            n_real)
        graphs = _selection_graphs(step, keys, pop, st, rounds, start, mesh,
                                   n_real)

    def whole(p):
        return p if mesh is None else mesh.gather(p, n_real)

    ck = _make_checkpointer(checkpoint_path, checkpoint_every, rounds, meta)
    for a, b in segment_bounds(start, rounds,
                               ck.every if ck is not None else None):
        for _ in range(a, b):
            graphs.run("round")
        parts.append(graphs.fetch(a, b))
        if ck is not None and ck.due(b):
            carry = graphs.carry()
            state = {"pop": whole(carry["pop"]), "st": carry["st"]}
            if mesh is None or mesh.rank == 0:
                ck.save(b, state, {"traj": _concat_traj(parts)})
    carry = graphs.carry()
    return whole(carry["pop"]), carry["st"], _concat_traj(parts)


def run_rounds_scanned(key: torch.Tensor, sel_cfg: SelectorConfig,
                       pop: ClientPopulation, sel_state: SelectorState,
                       energy_model: EnergyModel, model_bytes: float,
                       local_steps: int, batch_size: int, rounds: int,
                       deadline_s: Optional[float] = None,
                       up_bytes: Optional[float] = None,
                       faults: Optional[FaultConfig] = None,
                       checkpoint_every: Optional[int] = None,
                       checkpoint_path: Optional[str] = None,
                       resume_from: Optional[str] = None,
                       ) -> Tuple[ClientPopulation, SelectorState,
                                  Dict[str, np.ndarray]]:
    """Advance selection + energy + battery for ``rounds`` rounds with no
    host read inside a round: replayed from a CUDA graph on the card, run
    eagerly on the CPU. Round r uses row r of ``split(key, rounds)``.

    Returns ``(final_pop, final_state, trajectory)``, the trajectory as
    numpy arrays: ``selected (R,k)`` int32, ``chosen (R,k)``, ``succeeded
    (R,k)`` (per slot), ``round_duration``, ``new_dropouts``,
    ``energy_spent_pct``, ``energy_spent_j``, ``mean_battery``,
    ``total_dropped``, ``retries (R,)`` and ``corrupt (R,k)``.

    ``checkpoint_path`` (+ ``checkpoint_every`` rounds, default the last
    only) snapshots the carry and the trajectory so far;
    ``resume_from`` continues from such a snapshot, bitwise equal to the
    uninterrupted run."""
    return _run_selection_engine(
        key, sel_cfg, pop, sel_state, energy_model, model_bytes, local_steps,
        batch_size, rounds, deadline_s, up_bytes, faults, checkpoint_every,
        checkpoint_path, resume_from)


def run_rounds_sharded(key: torch.Tensor, sel_cfg: SelectorConfig,
                       pop: ClientPopulation, sel_state: SelectorState,
                       energy_model: EnergyModel, model_bytes: float,
                       local_steps: int, batch_size: int, rounds: int,
                       deadline_s: Optional[float] = None,
                       up_bytes: Optional[float] = None,
                       mesh=None, n_shards: Optional[int] = None,
                       faults: Optional[FaultConfig] = None,
                       checkpoint_every: Optional[int] = None,
                       checkpoint_path: Optional[str] = None,
                       resume_from: Optional[str] = None,
                       ) -> Tuple[ClientPopulation, SelectorState,
                                  Dict[str, np.ndarray]]:
    """:func:`run_rounds_scanned` over a ``clients`` mesh (``mesh``, or one
    of ``n_shards`` shards from ``launch/mesh.py::make_client_mesh``).

    Pads the population to a multiple of the shard count (pad clients are
    dead and never selected), lays it out in shard blocks, and runs every
    round shard-local, replayed from a CUDA graph on the card.
    ``selected``, ``chosen``, ``succeeded``, dropouts and the selector
    state equal :func:`run_rounds_scanned`'s on the same key index for
    index; the summed statistics (``energy_spent_pct``,
    ``mean_battery``) agree within float32 reduction order. The returned
    population is trimmed to the real clients, on every process.

    Checkpoints are the scanned engine's ``"sync"`` family with the
    population trimmed to the real clients, so a snapshot resumes under
    any shard count and in either engine. On a process-group mesh rank 0
    writes them."""
    from repro_torch.launch.mesh import make_client_mesh

    return _run_selection_engine(
        key, sel_cfg, pop, sel_state, energy_model, model_bytes, local_steps,
        batch_size, rounds, deadline_s, up_bytes, faults, checkpoint_every,
        checkpoint_path, resume_from,
        make_client_mesh(n_shards) if mesh is None else mesh)


# ------------------------------------------------------------------- async
# FedBuff-style buffered-asynchronous engine (Nguyen et al., AISTATS'22).
# Every selected client finishes at its own event-clock time instead of a
# synchronous barrier; the server aggregates whenever `buffer_size`
# completions have arrived, damping each delta by 1/(1+staleness)**p, and
# refills the freed concurrency slots from the same selectors the sync
# engine uses. One step is one server aggregation:
#
#   flush:  take the `buffer_size` earliest completions off the per-client
#           event clock, debit battery and dropouts through
#           simulate_round_device (arrival offsets play the round times;
#           clients still in flight do not drain at the idle rate),
#           advance the server clock to the last arrival, bump the version;
#   refill: select `buffer_size` replacements (in-flight clients masked out
#           of the candidates) and start their clocks at the new time.
#
# With buffer_size == max_concurrency == k and staleness_power = 0 every
# flush completes exactly the cohort the previous refill started, so the
# engine reproduces run_rounds_scanned's selection trajectory.
#
# Over a ``clients`` mesh the same step runs on shard blocks, as the sync
# round does: the flush takes each shard's earliest arrivals and merges
# them in lax.top_k's order, the completers' start versions and outcomes
# come from their one owner, the refill is _device_select's tournament,
# and a slot's clock is armed by its owner. Every per-client update is
# elementwise and every cross-shard reduction exact (max, integer sums,
# one-owner gathers) or a float sum reordered by shard, so the trajectory
# is index for index run_async_scanned's (run_async_sharded).


def _async_knobs(sel_cfg: SelectorConfig, buffer_size: Optional[int],
                 max_concurrency: Optional[int]):
    """Normalise and validate the FedBuff knobs: ``(buffer_size,
    max_concurrency, fill_cfg, refill_cfg)``, the selector configs that
    prime the concurrency slots (k = max_concurrency) and refill after
    each flush (k = buffer_size)."""
    buffer_size = sel_cfg.k if buffer_size is None else int(buffer_size)
    max_concurrency = (sel_cfg.k if max_concurrency is None
                       else int(max_concurrency))
    if buffer_size < 1:
        raise ValueError("buffer_size must be >= 1")
    if max_concurrency < buffer_size:
        raise ValueError("max_concurrency must be >= buffer_size "
                         f"({max_concurrency} < {buffer_size})")
    fill_cfg = dataclasses.replace(sel_cfg, k=max_concurrency)
    refill_cfg = dataclasses.replace(sel_cfg, k=buffer_size)
    return buffer_size, max_concurrency, fill_cfg, refill_cfg


class AsyncEventState(NamedTuple):
    """The async engine's event bookkeeping, on the population's device.

    ``t_done`` holds each in-flight client's *remaining* seconds from the
    last aggregation (+inf when idle), not an absolute clock: offsets are
    what the flush order, the wall advance, the deadline and
    ``last_duration`` need, and they keep ``(clock + t) - clock`` drift out
    of the sync-parity limit. Each flush advances ``server_clock`` by the
    aggregation's wall time and re-bases the survivors' offsets."""

    t_done: torch.Tensor           # (N,) f32 remaining seconds; +inf idle
    start_version: torch.Tensor    # (N,) i32 server version when started
    server_clock: torch.Tensor     # f32 0-d, absolute seconds
    server_version: torch.Tensor   # i32 0-d, aggregations so far
    spent_j: torch.Tensor          # f32 0-d, cumulative joules debited
    exhausted_round: torch.Tensor  # i32 0-d, first budget-refused agg (0)

    @classmethod
    def create(cls, n: int, device=None) -> "AsyncEventState":
        f = dict(dtype=torch.float32, device=device)
        i = dict(dtype=torch.int32, device=device)
        return cls(t_done=torch.full((n,), float("inf"), **f),
                   start_version=torch.zeros((n,), **i),
                   server_clock=torch.zeros((), **f),
                   server_version=torch.zeros((), **i),
                   spent_j=torch.zeros((), **f),
                   exhausted_round=torch.zeros((), **i))

    @property
    def in_flight(self) -> torch.Tensor:
        return torch.isfinite(self.t_done)


def _start_clients(astate: AsyncEventState, idx: torch.Tensor,
                   chosen: torch.Tensor, t_total: torch.Tensor,
                   axis=None) -> AsyncEventState:
    """Arm the event clock of the chosen slots' clients: they start at the
    current aggregation point, so their remaining time is their round
    time. On a ``clients`` mesh (``axis``) each shard arms the slots it
    owns, from its own block of ``t_total``."""
    if axis is None:
        return astate._replace(
            t_done=scatter_drop(astate.t_done, idx, chosen, t_total[idx]),
            start_version=scatter_drop(
                astate.start_version, idx, chosen,
                astate.server_version.expand(idx.shape[0])))
    n_loc = t_total.shape[-1]
    own, loc = _slot_owner(idx, axis.bases(n_loc, idx.device), n_loc)
    keep = own & chosen
    return astate._replace(
        t_done=scatter_drop_rows(astate.t_done, loc, keep,
                                 t_total.gather(-1, loc)),
        start_version=scatter_drop_rows(
            astate.start_version, loc, keep,
            astate.server_version.expand(idx.shape[0])))


def _astate_put(astate: AsyncEventState, mesh) -> AsyncEventState:
    """An event state of the real clients laid out on ``mesh``: padded
    with idle slots (+inf, version 0; pad clients are dead, never started,
    so they keep these values through a run) to this process's ``(S,
    n_loc)`` blocks. The reference's ``_pad_astate``."""
    n = astate.t_done.shape[0]
    pad = mesh.n_padded(n) - n
    return astate._replace(
        t_done=mesh.put(torch.cat([astate.t_done,
                                   astate.t_done.new_full((pad,),
                                                          float("inf"))])),
        start_version=mesh.put(torch.cat([
            astate.start_version, astate.start_version.new_zeros((pad,))])))


def _astate_gather(astate: AsyncEventState, mesh,
                   n: int) -> AsyncEventState:
    """The inverse of :func:`_astate_put`: the whole event state trimmed
    to the ``n`` real clients, on every process."""
    return astate._replace(t_done=mesh.gather(astate.t_done, n),
                           start_version=mesh.gather(astate.start_version,
                                                     n))


def make_async_round_engine(sel_cfg: SelectorConfig,
                            energy_model: EnergyModel,
                            model_bytes: float, local_steps: int,
                            batch_size: int,
                            buffer_size: Optional[int] = None,
                            max_concurrency: Optional[int] = None,
                            staleness_power: float = 0.5,
                            deadline_s: Optional[float] = None,
                            up_bytes: Optional[float] = None,
                            energy_budget_j: Optional[float] = None,
                            mesh=None, n_real: Optional[int] = None):
    """The FedBuff event engine: ``(init_fill, step)``, neither reading a
    value on the host. The top-k kernel runs on CUDA and the
    affine-folded plain route on the CPU, as in ``select``.

    ``init_fill(key, pop, sel_state, astate)`` primes ``max_concurrency``
    slots (no battery is debited: debits happen at completion) and
    returns ``(sel_state, astate, idx, chosen)``.

    ``step(key, pop, sel_state, astate, do_refill)`` flushes and refills
    once: ``(pop, sel_state, astate, flush, (ridx, rchosen))``, ``flush``
    the completion batch (``completed``, ``comp_chosen``, ``succeeded``,
    ``staleness``, ``agg_weight``, ``round_duration``, ``new_dropouts``,
    ``energy_spent_pct``, ``energy_spent_j``). ``do_refill`` is a 0-d
    bool tensor: False flushes without starting clients or advancing the
    selector (the last step of a fixed-length run).

    ``energy_budget_j`` gates a fill or refill batch all or nothing:
    spent joules (debited at completion) plus the committed cost of every
    in-flight client plus the batch's predicted cost must fit, so the
    debits can never overshoot. ``deadline_s`` abandons an arrival more
    than ``deadline_s`` seconds after the previous aggregation (it still
    pays its energy), the sync engine's deadline.

    With a ``clients`` ``mesh`` both take the population and the event
    state's per-client fields in shard blocks, padded from ``n_real``
    clients (:func:`_astate_put`), and their outputs are index for index
    the single-device ones (the reference's ``make_sharded_async_engine``):
    the flush merges each shard's earliest arrivals in ``lax.top_k``'s
    order, selection is ``_device_select``'s tournament, and the slots'
    per-client values come from their one owner. The round cost is
    computed in the step from the (elementwise) population, in both
    layouts, as the sync selection engine does."""
    buffer_size, _, fill_cfg, refill_cfg = _async_knobs(
        sel_cfg, buffer_size, max_concurrency)

    def _select(key, cfg, sel_state, pop, cost, astate):
        # in-flight clients must not be selected again: they leave the
        # candidates through `dropped` (a copy for the selection only)
        sel_pop = pop.replace(dropped=pop.dropped | astate.in_flight)
        return _device_select(key, cfg, sel_state, sel_pop, cost,
                              pop.device.type == "cuda", axis=mesh,
                              n_real=n_real)

    def _admit_batch(astate, pop, cost, idx, chosen, rnd):
        """The gated ``chosen`` and the astate with ``exhausted_round``
        stamped at the first refusal; the decision is replicated."""
        if energy_budget_j is None:
            return chosen, astate
        cost_j = pct_to_joules(pop.category, cost)
        committed = asum(torch.where(astate.in_flight, cost_j,
                                     torch.zeros_like(cost_j)), mesh)
        batch_j = _slot_gather(cost_j, idx, chosen, mesh).sum()
        admit = (astate.spent_j + committed + batch_j
                 <= f32(energy_budget_j, cost_j))
        refused = chosen.any() & ~admit
        exhausted = torch.where((astate.exhausted_round == 0) & refused,
                                rnd.to(torch.int32), astate.exhausted_round)
        return chosen & admit, astate._replace(exhausted_round=exhausted)

    def init_fill(key, pop: ClientPopulation, sel_state: SelectorState,
                  astate: AsyncEventState):
        t_total, cost = _round_cost(pop, energy_model, model_bytes,
                                    local_steps, batch_size, up_bytes)
        idx, chosen, sel_state = _select(key, fill_cfg, sel_state, pop,
                                         cost, astate)
        chosen, astate = _admit_batch(astate, pop, cost, idx, chosen,
                                      astate.server_version + 1)
        astate = _start_clients(astate, idx, chosen, t_total, mesh)
        return sel_state, astate, idx, chosen

    def step(key, pop: ClientPopulation, sel_state: SelectorState,
             astate: AsyncEventState, do_refill: torch.Tensor):
        t_total, cost = _round_cost(pop, energy_model, model_bytes,
                                    local_steps, batch_size, up_bytes)
        n_loc = cost.shape[-1]

        # ---- flush: the buffer_size earliest arrivals, ties (equal times,
        # survivors clamped to 0) lowest index first, as lax.top_k; on a
        # mesh each shard's earliest min(buffer_size, n_loc), merged
        in_flight = astate.in_flight
        n_if = asum(in_flight, mesh).to(torch.int32)
        g = torch.where(in_flight, -astate.t_done, f32(float("-inf"), cost))
        if mesh is None:
            cidx = _top_k_idx(g, buffer_size)
        else:
            cidx = _merge_topk(g, buffer_size, min(buffer_size, n_loc),
                               mesh.bases(n_loc, cost.device), mesh)
        comp_chosen = torch.arange(cidx.shape[0], device=cost.device) < \
            torch.clamp_max(n_if, buffer_size)
        comp_mask = slot_mask(cidx, comp_chosen, n_loc, mesh)

        # remaining offsets from the previous aggregation play the sync
        # engine's round times: the slowest successful arrival advances the
        # clock, the deadline abandons late arrivals
        busy = in_flight & ~comp_mask
        rnd = astate.server_version + 1
        pop, dev = simulate_round_device(pop, comp_mask, astate.t_done,
                                         cost, rnd, energy_model,
                                         deadline_s, busy_mask=busy,
                                         axis=mesh)

        # the completers' start versions and outcomes from their one owner
        # (exact: int32 versions, 0/1 flags)
        start_v = _slot_gather(astate.start_version, cidx, comp_chosen, mesh,
                               dtype=torch.int32)
        staleness = torch.clamp_min(astate.server_version - start_v, 0)
        succeeded = (_slot_gather(dev.succeeded, cidx, comp_chosen, mesh)
                     > 0) & comp_chosen
        agg_weight = torch.where(
            succeeded, staleness_damping(staleness, staleness_power),
            f32(0.0, cost))

        # re-base survivors on the new aggregation point, clamped at 0: a
        # flush that failed whole under a loose deadline lasts the deadline,
        # which can overshoot a survivor's remaining time (it then arrives
        # at offset 0, never negative, which would run the clock backwards)
        any_comp = n_if > 0
        astate = astate._replace(
            t_done=torch.where(comp_mask, f32(float("inf"), cost),
                               torch.clamp_min(astate.t_done
                                               - dev.round_duration, 0.0)),
            server_clock=astate.server_clock + dev.round_duration,
            server_version=astate.server_version + any_comp.to(torch.int32),
            spent_j=astate.spent_j + dev.energy_spent_j)

        zero_i = torch.zeros_like(staleness)
        flush = {
            "completed": cidx.to(torch.int32),
            "comp_chosen": comp_chosen,
            "succeeded": succeeded,
            "staleness": torch.where(comp_chosen, staleness, zero_i),
            "agg_weight": agg_weight,
            "round_duration": dev.round_duration,
            "new_dropouts": dev.new_dropouts,
            "energy_spent_pct": dev.energy_spent_pct,
            "energy_spent_j": dev.energy_spent_j,
        }

        # ---- refill the freed slots -------------------------------------
        ridx, rchosen, new_st = _select(key, refill_cfg, sel_state, pop,
                                        cost, astate)
        rchosen = rchosen & do_refill
        rchosen, astate = _admit_batch(astate, pop, cost, ridx, rchosen,
                                       astate.server_version + 1)
        old = sel_state.canonical(pop.device)
        sel_state = SelectorState(*(
            torch.where(do_refill, getattr(new_st, f.name),
                        getattr(old, f.name))
            for f in dataclasses.fields(SelectorState)))
        astate = _start_clients(astate, ridx, rchosen, t_total, mesh)
        return pop, sel_state, astate, flush, (ridx, rchosen)

    return init_fill, step


def _async_graphs(step, keys: torch.Tensor, refill: torch.Tensor,
                  carry: Dict[str, Any], rounds: int, start: int,
                  mesh=None, n_real: Optional[int] = None) -> StepGraphs:
    """The selection-only async engine's aggregation over the carry
    ``{"pop", "st", "astate"}`` (the twin of the reference's
    ``_async_scanned_runner`` scan and, with a ``clients`` ``mesh`` and
    the carry in shard blocks padded from ``n_real`` clients, of its
    ``_sharded_async_runner``); aggregation ``ctr`` uses key row
    ``keys[ctr]`` and refills where ``refill[ctr]``."""
    n_real = carry["pop"].n if mesh is None else n_real
    n_pad = 0 if mesh is None else mesh.n_padded(n_real) - n_real

    def agg_fn(carry, ctr):
        at = ctr.reshape(1)
        pop, st, astate, flush, (ridx, rchosen) = step(
            keys.index_select(0, at)[0], carry["pop"], carry["st"],
            carry["astate"], refill.index_select(0, at)[0])
        out = {
            **flush,
            "selected": ridx.to(torch.int32),
            "chosen": rchosen,
            "server_clock": astate.server_clock,
            "n_inflight": asum(astate.in_flight, mesh).to(torch.int32),
            "mean_battery": asum(pop.battery_pct, mesh) / n_real,
            # pad clients are dead from the start
            "total_dropped": asum(pop.dropped, mesh).to(torch.int32) - n_pad,
            "budget_spent_j": astate.spent_j,
            "budget_exhausted": astate.exhausted_round,
        }
        return {"pop": pop, "st": st, "astate": astate}, out

    graphs = StepGraphs(carry, rounds, start)
    graphs.add("agg", agg_fn, advance=True)
    return graphs


def _async_xs(key: torch.Tensor, rounds: int):
    """The async engines' key stream: the sync engine's ``split(key,
    rounds)`` rows, so the parity limit reproduces its selections key for
    key. Row 0 primes the pipe and row r refills after flush r; the last
    flush refills nothing. Returns ``(key0, keys (R, 2), refill (R,))``."""
    keys = prng.split(key, rounds)
    refill = torch.arange(rounds, device=key.device) < rounds - 1
    return keys[0], torch.cat([keys[1:], keys[-1:]]), refill


def _async_fill_prepend(traj: Dict[str, Any], idx0, chosen0,
                        b: int) -> Dict[str, Any]:
    """The selection trajectory aligned with the sync engine's: row r is
    the cohort *started* for aggregation r+1 (the fill, cut to the refill
    width, then the refills); the whole fill is kept as ``fill_selected``
    and ``fill_chosen``. Returns a new dict."""
    idx0, chosen0 = np.asarray(idx0), np.asarray(chosen0)
    traj = dict(traj)
    traj["fill_selected"], traj["fill_chosen"] = idx0, chosen0
    traj["selected"] = np.concatenate([idx0[None, :b],
                                       np.asarray(traj["selected"])[:-1]])
    traj["chosen"] = np.concatenate([chosen0[None, :b],
                                     np.asarray(traj["chosen"])[:-1]])
    return traj


def _run_async_engine(key: torch.Tensor, sel_cfg: SelectorConfig,
                      pop: ClientPopulation, sel_state: SelectorState,
                      energy_model: EnergyModel, model_bytes: float,
                      local_steps: int, batch_size: int, rounds: int,
                      buffer_size: Optional[int],
                      max_concurrency: Optional[int],
                      staleness_power: float, deadline_s: Optional[float],
                      up_bytes: Optional[float],
                      faults: Optional[FaultConfig],
                      checkpoint_every: Optional[int],
                      checkpoint_path: Optional[str],
                      resume_from: Optional[str], mesh=None):
    """The async selection engine's fill, segment, checkpoint and resume
    loop, on one device or over a ``clients`` ``mesh`` (the population
    and the event state padded and laid out in shard blocks for the run,
    and trimmed to the real clients in snapshots and in the result, on
    every process; rank 0 of a process-group mesh writes the snapshots).
    The snapshots are the ``"async"`` family whatever the layout, so they
    resume under any shard count and in either engine."""
    from repro_torch.launch.sharding import population_sharding

    if faults is not None and faults.active:
        raise ValueError(
            "fault injection is not supported by the async event engines "
            "(no per-round fault boundary); use the sync engines")
    n_real = pop.n
    init_fill, step = make_async_round_engine(
        sel_cfg, energy_model, float(model_bytes), int(local_steps),
        int(batch_size), buffer_size, max_concurrency,
        float(staleness_power),
        None if deadline_s is None else float(deadline_s),
        None if up_bytes is None else float(up_bytes), mesh=mesh,
        n_real=n_real)
    b, c, _, _ = _async_knobs(sel_cfg, buffer_size, max_concurrency)
    dev = pop.device
    meta = _engine_meta("async", sel_cfg, n_real, rounds, deadline_s, faults,
                        buffer_size=b, max_concurrency=c,
                        staleness_power=float(staleness_power))
    start, parts = 0, []
    with setup_transfers():     # one-time host-to-device materialisation
        key0, keys, refill = _async_xs(key, rounds)
        st = sel_state.canonical(dev)
        astate = AsyncEventState.create(n_real, dev)
        if resume_from is not None:
            start, state, data, _ = load_engine_checkpoint(
                resume_from, {"pop": pop, "st": st, "astate": astate},
                expect_meta=meta)
            pop, st, astate = state["pop"], state["st"], state["astate"]
            idx0, chosen0 = data["fill_selected"], data["fill_chosen"]
            if data.get("traj"):
                parts.append(data["traj"])
        if mesh is not None:
            pop = population_sharding(mesh)(pop)
            astate = _astate_put(astate, mesh)
        if resume_from is None:
            st, astate, idx0, chosen0 = init_fill(key0, pop, st, astate)
            idx0 = idx0.to(torch.int32).cpu().numpy()
            chosen0 = chosen0.cpu().numpy()
        graphs = _async_graphs(step, keys, refill,
                               {"pop": pop, "st": st, "astate": astate},
                               rounds, start, mesh, n_real)

    def to_file(carry):
        if mesh is None:
            return carry
        return dict(carry, pop=mesh.gather(carry["pop"], n_real),
                    astate=_astate_gather(carry["astate"], mesh, n_real))

    ck = _make_checkpointer(checkpoint_path, checkpoint_every, rounds, meta)
    for a, e in segment_bounds(start, rounds,
                               ck.every if ck is not None else None):
        for _ in range(a, e):
            graphs.run("agg")
        parts.append(graphs.fetch(a, e))
        if ck is not None and ck.due(e):
            state = to_file(graphs.carry())
            if mesh is None or mesh.rank == 0:
                ck.save(e, state, {"traj": _concat_traj(parts),
                                   "fill_selected": idx0,
                                   "fill_chosen": chosen0})
    carry = to_file(graphs.carry())
    traj = _async_fill_prepend(_concat_traj(parts), idx0, chosen0, b)
    traj["final_event_state"] = carry["astate"]
    return carry["pop"], carry["st"], traj


def run_async_scanned(key: torch.Tensor, sel_cfg: SelectorConfig,
                      pop: ClientPopulation, sel_state: SelectorState,
                      energy_model: EnergyModel, model_bytes: float,
                      local_steps: int, batch_size: int, rounds: int,
                      buffer_size: Optional[int] = None,
                      max_concurrency: Optional[int] = None,
                      staleness_power: float = 0.5,
                      deadline_s: Optional[float] = None,
                      up_bytes: Optional[float] = None,
                      faults: Optional[FaultConfig] = None,
                      checkpoint_every: Optional[int] = None,
                      checkpoint_path: Optional[str] = None,
                      resume_from: Optional[str] = None,
                      ) -> Tuple[ClientPopulation, SelectorState,
                                 Dict[str, Any]]:
    """The FedBuff twin of :func:`run_rounds_scanned`: ``rounds`` server
    aggregations, each one step with no host read, replayed from a CUDA
    graph on the card and run eagerly on the CPU (the fill runs once,
    eagerly).

    The trajectory holds, per aggregation, the completion batch
    (``completed (R,B)``, ``comp_chosen``, ``succeeded``, ``staleness``,
    ``agg_weight``: the damping factors, 0 for failed slots), the refilled
    cohort (``selected (R,B)``, ``chosen``: row r the cohort started for
    aggregation r+1, the sync trajectory in the parity limit), the wall
    (``round_duration`` between aggregations, ``server_clock``),
    ``n_inflight`` (never above ``max_concurrency``) and the sync scan's
    dropout and battery fields; ``final_event_state`` is the last
    :class:`AsyncEventState`.

    ``checkpoint_path``/``checkpoint_every``/``resume_from`` snapshot the
    carry (population, selector state, event state) between
    aggregations; a resumed run is bitwise the uninterrupted one.
    ``faults`` are rejected: the event engine has no round boundary for
    the per-round fault draws."""
    return _run_async_engine(
        key, sel_cfg, pop, sel_state, energy_model, model_bytes, local_steps,
        batch_size, rounds, buffer_size, max_concurrency, staleness_power,
        deadline_s, up_bytes, faults, checkpoint_every, checkpoint_path,
        resume_from)


def run_async_sharded(key: torch.Tensor, sel_cfg: SelectorConfig,
                      pop: ClientPopulation, sel_state: SelectorState,
                      energy_model: EnergyModel, model_bytes: float,
                      local_steps: int, batch_size: int, rounds: int,
                      buffer_size: Optional[int] = None,
                      max_concurrency: Optional[int] = None,
                      staleness_power: float = 0.5,
                      deadline_s: Optional[float] = None,
                      up_bytes: Optional[float] = None,
                      mesh=None, n_shards: Optional[int] = None,
                      faults: Optional[FaultConfig] = None,
                      checkpoint_every: Optional[int] = None,
                      checkpoint_path: Optional[str] = None,
                      resume_from: Optional[str] = None,
                      ) -> Tuple[ClientPopulation, SelectorState,
                                 Dict[str, Any]]:
    """:func:`run_async_scanned` over a ``clients`` mesh (``mesh``, or one
    of ``n_shards`` shards from ``launch/mesh.py::make_client_mesh``).

    Pads the population and the event state to a multiple of the shard
    count (pad clients are dead, never selected, never in flight), lays
    them out in shard blocks, and runs every aggregation shard-local,
    replayed from a CUDA graph on the card. The trajectory (completion
    order, staleness, damping weights, refills, the wall clock, in-flight
    and dropout counts) and the selector state equal
    :func:`run_async_scanned`'s on the same key index for index; the
    summed statistics (``energy_spent_pct``, ``mean_battery``) agree
    within float32 reduction order. The returned population and
    ``final_event_state`` are trimmed to the real clients, on every
    process.

    Snapshots are the ``"async"`` family with the population and event
    state trimmed, so a snapshot resumes under any shard count and in
    either engine; rank 0 of a process-group mesh writes them. ``faults``
    are rejected, as in :func:`run_async_scanned`."""
    from repro_torch.launch.mesh import make_client_mesh

    return _run_async_engine(
        key, sel_cfg, pop, sel_state, energy_model, model_bytes, local_steps,
        batch_size, rounds, buffer_size, max_concurrency, staleness_power,
        deadline_s, up_bytes, faults, checkpoint_every, checkpoint_path,
        resume_from, make_client_mesh(n_shards) if mesh is None else mesh)


# -------------------------------------------------------------- dispatcher
# One front door over the four round engines. The pick is a pure function
# of (n, device_count, mode, async knobs), the reference's, so dispatch
# decisions match between the packages.

#: Population size at or above which a multi-device run dispatches to the
#: sharded engines. The reference's value (its CPU-mesh measurement); it
#: is not measured on H100s, which takes a machine of several cards.
ENGINE_CUTOVER_N = 262_144

SYNC_ENGINES = ("scanned", "sharded")
ASYNC_ENGINES = ("async-scanned", "async-sharded")
ENGINES = SYNC_ENGINES + ASYNC_ENGINES

#: Training engines behind ``run_fl``: the host round loop, the fused
#: engine (``run_fl_scanned`` / ``run_fl_async_scanned``) and the sharded
#: twin (``run_fl_sharded`` / ``run_fl_async_sharded``). Every name exists
#: in both aggregation families.
TRAIN_ENGINES = ("host", "scanned", "sharded")

def world_size() -> int:
    """Devices a run is planned across: the world size of an initialised
    ``torch.distributed`` group, else 1. Not ``torch.cuda.device_count()``:
    the sharded twins run one process a card, so one process on a host of
    many cards plans for one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def resolve_train_engine(n: int, device_count: Optional[int] = None, *,
                         mode: str = "sync", engine: str = "auto",
                         cutover_n: Optional[int] = None) -> str:
    """Pick the training engine for ``run_fl``, as the reference does. An
    explicit name in :data:`TRAIN_ENGINES` passes through. ``"auto"`` keeps
    the host loop in the sync family and picks the device engines in the
    async family: ``"sharded"`` on more than one device, else
    ``"scanned"``."""
    if engine == "auto":
        if mode != "async":
            return "host"
        if device_count is None:
            device_count = world_size()
        return "sharded" if device_count > 1 else "scanned"
    if engine not in TRAIN_ENGINES:
        raise ValueError(f"unknown training engine {engine!r}; expected "
                         f"'auto' or one of {TRAIN_ENGINES}")
    return engine


def resolve_aggregation(mode: str, buffer_size: Optional[int] = None,
                        max_concurrency: Optional[int] = None) -> str:
    """``"sync"`` or ``"async"`` from a user's mode. ``"auto"`` is async
    exactly when ``buffer_size`` or ``max_concurrency`` is set (they have
    no synchronous meaning); engine names map to their family."""
    if mode in ("sync", "async"):
        return mode
    if mode in SYNC_ENGINES:
        return "sync"
    if mode in ASYNC_ENGINES:
        return "async"
    if mode == "auto":
        return ("async" if buffer_size is not None
                or max_concurrency is not None else "sync")
    raise ValueError(f"unknown mode {mode!r}; expected 'auto', 'sync', "
                     f"'async', or one of {ENGINES}")


def resolve_engine(n: int, device_count: Optional[int] = None, *,
                   mode: str = "auto",
                   buffer_size: Optional[int] = None,
                   max_concurrency: Optional[int] = None,
                   cutover_n: Optional[int] = None) -> str:
    """Pick the round engine for ``n`` clients: the family from ``mode``
    and the async knobs (:func:`resolve_aggregation`; an engine name as
    ``mode`` wins outright), the placement sharded iff ``device_count > 1``
    and ``n >= cutover_n`` (default :data:`ENGINE_CUTOVER_N`). Returns
    one of :data:`ENGINES`."""
    if mode in ENGINES:
        return mode
    family = resolve_aggregation(mode, buffer_size, max_concurrency)
    if device_count is None:
        device_count = world_size()
    if cutover_n is None:
        cutover_n = ENGINE_CUTOVER_N
    sharded = device_count > 1 and n >= cutover_n
    if family == "async":
        return "async-sharded" if sharded else "async-scanned"
    return "sharded" if sharded else "scanned"


def run_rounds(key: torch.Tensor, sel_cfg: SelectorConfig,
               pop: ClientPopulation, sel_state: SelectorState,
               energy_model: EnergyModel, model_bytes: float,
               local_steps: int, batch_size: int, rounds: int, *,
               mode: str = "auto",
               deadline_s: Optional[float] = None,
               up_bytes: Optional[float] = None,
               buffer_size: Optional[int] = None,
               max_concurrency: Optional[int] = None,
               staleness_power: float = 0.5,
               mesh=None, n_shards: Optional[int] = None,
               cutover_n: Optional[int] = None,
               faults: Optional[FaultConfig] = None,
               checkpoint_every: Optional[int] = None,
               checkpoint_path: Optional[str] = None,
               resume_from: Optional[str] = None,
               ) -> Tuple[ClientPopulation, SelectorState, Dict[str, Any]]:
    """One front door over the round engines, through
    :func:`resolve_engine`: ``mode`` picks the family (``"auto"`` infers
    async from ``buffer_size``/``max_concurrency``) or, as an engine name,
    the engine; the population size against ``cutover_n`` on more than one
    device picks the placement, and ``mesh``/``n_shards`` upgrade an
    auto-resolved engine to its sharded twin (``mesh``, a
    ``launch/mesh.py::ClientMesh``, or a virtual mesh of ``n_shards``).
    The chosen name is recorded as ``traj["engine"]``. The reference's
    checks, in its order: an unknown mode, a forced single-device name
    with ``mesh``/``n_shards``, async knobs with a sync engine (each a
    ``ValueError``)."""
    if mesh is not None:
        devices = mesh.size()
    elif n_shards is not None:
        devices = n_shards
    else:
        devices = world_size()
    engine = resolve_engine(pop.n, devices, mode=mode,
                            buffer_size=buffer_size,
                            max_concurrency=max_concurrency,
                            cutover_n=cutover_n)
    if mesh is not None or n_shards is not None:
        if mode in ("scanned", "async-scanned"):
            raise ValueError(
                f"mode={mode!r} forces a single-device engine but "
                f"mesh/n_shards was passed; drop one of the two")
        engine = {"scanned": "sharded",
                  "async-scanned": "async-sharded"}.get(engine, engine)
    if engine in SYNC_ENGINES and (buffer_size is not None
                                   or max_concurrency is not None):
        raise ValueError(
            f"async knobs (buffer_size/max_concurrency) with the "
            f"synchronous {engine!r} engine; use mode='async' or drop "
            f"the knobs")
    common = dict(deadline_s=deadline_s, up_bytes=up_bytes, faults=faults,
                  checkpoint_every=checkpoint_every,
                  checkpoint_path=checkpoint_path, resume_from=resume_from)
    args = (key, sel_cfg, pop, sel_state, energy_model, model_bytes,
            local_steps, batch_size, rounds)
    if engine == "scanned":
        fpop, st, traj = run_rounds_scanned(*args, **common)
    elif engine == "sharded":
        fpop, st, traj = run_rounds_sharded(*args, **common, mesh=mesh,
                                            n_shards=n_shards)
    else:
        knobs = dict(buffer_size=buffer_size,
                     max_concurrency=max_concurrency,
                     staleness_power=staleness_power, **common)
        if engine == "async-scanned":
            fpop, st, traj = run_async_scanned(*args, **knobs)
        else:
            fpop, st, traj = run_async_sharded(*args, **knobs, mesh=mesh,
                                               n_shards=n_shards)
    traj["engine"] = engine
    return fpop, st, traj
