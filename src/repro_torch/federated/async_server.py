"""FedBuff-style buffered-asynchronous FL server, in PyTorch (the async
twin of :func:`repro_torch.federated.server.run_fl`).

EAFL's central failure mode is the synchronous barrier: every selected
client must finish before aggregation, so stragglers stretch
time-to-accuracy and drained devices are abandoned at the deadline. Here
each client trains on its own clock (the event engine of
``federated/simulation.py``): the server aggregates whenever
``buffer_size`` updates have arrived, damps each delta by
``1/(1+staleness)**staleness_power`` (FedBuff, Nguyen et al. AISTATS'22)
and refills the freed concurrency slots at once.

Training is real and staleness is physical: every completer trains from
the parameter version it downloaded, and its delta is applied to the
*current* parameters as a damped pseudo-gradient. Two engines share one
trajectory:

- :func:`run_fl_async`, the host event loop, one engine step an
  aggregation and the training dispatched from the host: the oracle of
  the fused engine;
- :func:`run_fl_async_scanned`, the whole aggregation (flush, canonical
  reorder, stale-start cohort SGD, damped aggregation, server update,
  refill) as one step with no host read, replayed from a CUDA graph on
  the card (``federated/replay.py``) and run eagerly on the CPU. The
  parameter versions live in a fixed-size snapshot ring
  (:class:`SnapshotRingState`) in the carry.

RNG contract (both engines, the reference's): every aggregation, and the
fill, burns one ``kloop, ksel, ktrain, krecharge = split(kloop, 4)`` as a
sync round does. The fill's ``ksel`` primes the pipe and aggregation r's
``ksel`` refills. Train keys are anchored to versions: the ``ktrain`` of
the split that created version ``v`` is kept in its ring slot, and a
completer of ``v`` trains with ``split(tkey_v, max_concurrency)[succ_v +
rank]``, ``succ_v`` the earlier successful completers of ``v`` and
``rank`` its success rank within the flush among ``v``'s rows. The
recharge uses the *previous* split's ``krecharge``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch import prng
from repro_torch.analysis.runtime import setup_transfers
from repro_torch.checkpoint import load_engine_checkpoint
from repro_torch.core.clients import scatter_stat_util
from repro_torch.core.fairness import jains_index
from repro_torch.core.rewards import stat_utility
from repro_torch.core.selection import (SelectorState, _slot_gather,
                                        _slot_owner)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated.aggregation import (finite_rows, server_update,
                                               tree_finite, weighted_delta,
                                               zero_nonfinite_rows)
from repro_torch.federated.server import (FLConfig, FLHistory, _SlotSplit,
                                          _accuracy_fn, _cohort_train_fn,
                                          _fused_setup, _print_fused_history,
                                          _recharge_device, _recharge_step,
                                          _record_test_acc,
                                          _run_fused_elastic, _train_meta)
from repro_torch.federated.simulation import (AsyncEventState, _astate_put,
                                              _async_knobs,
                                              _make_checkpointer,
                                              make_async_round_engine,
                                              scatter_drop_rows)
from repro_torch.launch.mesh import asum
from repro_torch.launch.sharding import population_sharding, shard_clients

_I32_MAX = int(np.iinfo(np.int32).max)


class _SnapshotRing:
    """Host refcounted parameter versions (a dict): the specification of
    :class:`SnapshotRingState`, which ``tests/test_torch_snapshot_ring.py``
    drives through the same random retain and release traffic. The
    engines use the array ring."""

    def __init__(self):
        self._params: Dict[int, Any] = {}
        self._refs: Dict[int, int] = {}

    def retain(self, version: int, params, count: int):
        if count <= 0:
            return
        if version not in self._params:
            self._params[version] = params
        self._refs[version] = self._refs.get(version, 0) + count

    def get(self, version: int):
        return self._params[version]

    def release(self, version: int):
        self._refs[version] -= 1
        if self._refs[version] == 0:
            del self._refs[version]
            del self._params[version]

    @property
    def live_versions(self) -> int:
        return len(self._params)


# ------------------------------------------------------ the snapshot ring
# `size` slots of stacked parameters with (version, refcount, train key,
# success count) rows; free slots have version -1. size = max_concurrency
# suffices: every live version has at least one holder in flight, there
# are never more than max_concurrency in flight, so a retain with count >
# 0 always finds a free slot (versions only grow and a version with no
# holder has been freed, so a retain never tops up a live slot).


class SnapshotRingState(NamedTuple):
    """``size`` parameter versions in the engine carry: ``params`` stacks
    every model leaf on a leading ``size`` axis; ``version`` is -1 where
    free; ``refs`` counts in-flight holders; ``tkey`` is the train key
    (the port's int64 pair) of the split that made the version; ``succ``
    counts its completers that already trained successfully (the base of
    the success-rank key index)."""

    params: Any                # tree, each leaf (size, ...)
    version: torch.Tensor      # (size,) i32, -1 free
    refs: torch.Tensor         # (size,) i32
    tkey: torch.Tensor         # (size, 2) int64
    succ: torch.Tensor         # (size,) i32

    @property
    def live_versions(self) -> torch.Tensor:
        return (self.version >= 0).sum().to(torch.int32)


def _ring_create(params, size: int) -> SnapshotRingState:
    """An all-free ring whose slots hold copies of ``params`` (free slots
    are never read through a version match)."""
    any_leaf = tree_leaves(params)[0]
    i32 = dict(dtype=torch.int32, device=any_leaf.device)
    return SnapshotRingState(
        params=tree_map(lambda p: p.unsqueeze(0).repeat(
            size, *([1] * p.ndim)), params),
        version=torch.full((size,), -1, **i32),
        refs=torch.zeros((size,), **i32),
        tkey=torch.zeros((size, 2), dtype=torch.int64,
                         device=any_leaf.device),
        succ=torch.zeros((size,), **i32))


def _ring_lookup(ring: SnapshotRingState,
                 versions: torch.Tensor) -> torch.Tensor:
    """The slot of each requested version, the first match. A version not
    live (masked rows ask for ``_I32_MAX``) falls back to slot 0: the
    caller's masks keep those rows out of everything downstream."""
    match = ring.version[None, :] == versions[:, None]
    return match.to(torch.int32).argmax(dim=1)


def _ring_release(ring: SnapshotRingState, versions: torch.Tensor,
                  chosen: torch.Tensor,
                  succ: torch.Tensor) -> SnapshotRingState:
    """Release one reference a chosen flush row (its ``versions`` entry)
    and add each successful completer to its version's ``succ`` base;
    slots whose count reaches zero are freed (version -1)."""
    member = (ring.version[:, None] == versions[None, :]) & chosen[None, :]
    released = member.sum(dim=1).to(torch.int32)
    succ_add = (member & succ[None, :]).sum(dim=1).to(torch.int32)
    refs = ring.refs - released
    freed = (released > 0) & (refs <= 0)
    return ring._replace(
        version=torch.where(freed, torch.full_like(ring.version, -1),
                            ring.version),
        refs=torch.clamp_min(refs, 0),
        succ=ring.succ + succ_add)


def _ring_retain(ring: SnapshotRingState, version, params, count,
                 tkey: torch.Tensor) -> SnapshotRingState:
    """Claim a free slot for ``count`` new holders of ``version`` (0-d
    tensors; nothing happens when ``count`` is 0). The parameters are
    copied into the ring's own tensors in place, which are returned, so a
    replayed step copies one model a retain, not the ring."""
    size = ring.version.shape[0]
    free = ring.version < 0
    slot = free.to(torch.int32).argmax().reshape(1)
    ok = (count > 0) & free.index_select(0, slot)[0]
    hit = (torch.arange(size, device=slot.device) == slot) & ok

    def put(r, p):
        # the slot's own content when nothing is retained
        row = torch.where(ok, p, r.index_select(0, slot)[0])
        return r.index_copy_(0, slot, row.unsqueeze(0))

    return SnapshotRingState(
        params=tree_map(put, ring.params, params),
        version=torch.where(hit, version.to(torch.int32), ring.version),
        refs=torch.where(hit, count.to(torch.int32), ring.refs),
        tkey=torch.where(hit[:, None], tkey, ring.tkey),
        succ=torch.where(hit, torch.zeros_like(ring.succ), ring.succ))


def _within_version_rank(versions: torch.Tensor,
                         succ: torch.Tensor) -> torch.Tensor:
    """Each row's success rank within its version over the canonically
    ordered flush: ``out[i] = #{j < i: v_j == v_i and succ_j}``."""
    b = versions.shape[0]
    same = versions[None, :] == versions[:, None]
    earlier = torch.ones((b, b), dtype=torch.bool,
                         device=versions.device).tril(-1)
    return (same & earlier & succ[None, :]).sum(dim=1).to(torch.int32)


def _flush_train_keys(tkeys: torch.Tensor, key_ix: torch.Tensor,
                      width: int) -> torch.Tensor:
    """Row i's train key ``split(tkeys[i], width)[key_ix[i]]``: threefry
    splits are prefix-stable, so a static ``width`` (max_concurrency)
    gives each row the host loop's key."""
    rows = torch.arange(tkeys.shape[0], device=tkeys.device)
    return prng.split(tkeys, width)[rows, key_ix.long()]


def _canonical_order(version_before: torch.Tensor, flush: Dict[str, Any],
                     ranks: torch.Tensor):
    """The fused engine's flush rows in the canonical order: by start
    version, then by selection-slot rank (``ranks``, each flush row's
    client's), masked rows last (they carry ``_I32_MAX`` and their own row
    number). Two completers of one version came from one selection batch,
    so their ranks differ and the order has no ties: the host loop's
    ``np.lexsort((rk, v_eff))`` and the reference's two-key ``lax.sort``,
    here one sort on ``v_eff * 2**32 + rk``. Returns ``(perm,
    v_eff[perm])``."""
    chosen = flush["comp_chosen"]
    rows = torch.arange(chosen.shape[0], dtype=torch.int32,
                        device=chosen.device)
    v_eff = torch.where(chosen, version_before - flush["staleness"],
                        torch.full_like(rows, _I32_MAX))
    rk = torch.where(chosen, ranks, rows)
    perm = torch.sort(v_eff.to(torch.int64) * 2**32 + rk.to(torch.int64),
                      stable=True).indices
    return perm, v_eff[perm]


def _check_async_cfg(cfg: FLConfig) -> None:
    """The async engines' rejections of structural knobs."""
    if cfg.overcommit != 1.0:
        raise ValueError("overcommit is a synchronous-barrier knob; the "
                         "async engine refills slots continuously instead")
    if cfg.faults is not None and cfg.faults.active:
        raise ValueError(
            "fault injection is defined per synchronous round; the async "
            "event engine has no per-round fault boundary: run faults "
            "through run_fl(mode='sync')")
    if cfg.controller is not None:
        raise ValueError(
            "the adaptive knob controller drives the synchronous host "
            "loop; the async engine's knobs (buffer_size, "
            "max_concurrency) are structural: use run_fl(cfg, "
            "mode='sync', engine='host')")


def _async_geometry(cfg: FLConfig):
    """``(buffer_size, max_concurrency, snapshot_ring_size)`` as every
    async engine sees them."""
    b, c, _, _ = _async_knobs(cfg.selector, cfg.buffer_size,
                              cfg.max_concurrency)
    r = c if cfg.snapshot_ring_size is None else int(cfg.snapshot_ring_size)
    if r < c:
        raise ValueError(
            "snapshot_ring_size must be >= max_concurrency "
            f"({r} < {c}): every in-flight client can in the worst case "
            "hold a distinct parameter version")
    return b, c, r


def _async_train_meta(cfg: FLConfig, family: str) -> Dict[str, Any]:
    """Checkpoint identity of an async training run, the reference's: the
    sync meta plus the normalised FedBuff geometry (a run with
    ``buffer_size=k`` and one with the default are the same run)."""
    b, c, r = _async_geometry(cfg)
    meta = _train_meta(cfg, family)
    meta.update(buffer_size=b, max_concurrency=c,
                staleness_power=float(cfg.staleness_power),
                snapshot_ring_size=r)
    return meta


def _async_engine(cfg: FLConfig, energy_model, sim_steps: int,
                  model_bytes: float, up_bytes, mesh=None,
                  n_real: Optional[int] = None):
    """The event engine both training engines step (the fused engine over
    its ``clients`` ``mesh``)."""
    return make_async_round_engine(
        cfg.selector, energy_model, model_bytes, sim_steps, cfg.batch_size,
        buffer_size=cfg.buffer_size, max_concurrency=cfg.max_concurrency,
        staleness_power=cfg.staleness_power, deadline_s=cfg.deadline_s,
        up_bytes=up_bytes, energy_budget_j=cfg.energy_budget_j, mesh=mesh,
        n_real=n_real)


def _fill(init_fill, kloop, params, pop, st, ring_size: int, astate):
    """Prime the concurrency slots at version 0 from the idle event state
    ``astate``: ``(kloop, krech, st, astate, ring, idx0, chosen0)``."""
    kloop, ksel, ktrain, krecharge = prng.split(kloop, 4).unbind(-2)
    st, astate, idx0, chosen0 = init_fill(ksel, pop, st, astate)
    ring = _ring_retain(_ring_create(params, ring_size),
                        astate.server_version, params,
                        chosen0.sum().to(torch.int32), ktrain)
    return kloop, krecharge, st, astate, ring, idx0, chosen0


def _slot_ranks(slot_rank: torch.Tensor, idx: torch.Tensor,
                chosen: torch.Tensor, mesh) -> torch.Tensor:
    """``slot_rank`` (shard blocks on ``mesh``) with each chosen slot's
    client set to its slot, by the slot's one owner."""
    n_loc = slot_rank.shape[-1]
    own, loc = _slot_owner(idx, mesh.bases(n_loc, idx.device), n_loc)
    return scatter_drop_rows(slot_rank, loc, own & chosen,
                             torch.arange(idx.shape[0], dtype=torch.int32,
                                          device=idx.device))


# ------------------------------------------------------- host event loop
# An aggregation: split(kloop, 4) -> engine step (flush + refill) ->
# canonical reorder -> recharge with the PREVIOUS split's krecharge ->
# start params and train keys from the ring -> cohort SGD over the
# successful rows -> quarantine and damped weighted aggregation -> gated
# server update -> ring release (flushed holders) and retain (refilled
# holders, on the new version) -> selection ranks of the refill batch.
# The ordering and key bookkeeping is the reference host loop's numpy
# (lexsort, argmax, a loop for the ranks), apart from the fused engine's
# tensor versions of it: the host loop is their oracle.


def run_fl_async(cfg: FLConfig, verbose: bool = False,
                 device: DeviceLike = None,
                 _trace: Optional[list] = None) -> FLHistory:
    """Buffered-asynchronous FL, ``cfg.rounds`` server aggregations, the
    host event loop (``run_fl(cfg, mode="async", engine="host")``), on
    ``device`` (the CUDA card unless ``device="cpu"``).

    One history row an aggregation; ``round_duration`` is the wall time
    between aggregations, so ``wall_hours`` compares with the sync
    loop's. ``cfg.buffer_size`` and ``cfg.max_concurrency`` default to
    ``selector.k`` (the sync-parity regime), and ``cfg.staleness_power``
    damps stale deltas. ``cfg.checkpoint_path`` snapshots the carry (the
    ring, the selection ranks and both keys included) and the history
    (``"train-async-host"`` family: a snapshot the reference wrote resumes
    here); ``cfg.resume_from`` continues one.

    ``_trace`` (tests only): a list that receives one dict an aggregation
    with the canonically ordered flush and refill columns."""
    _check_async_cfg(cfg)
    _, max_concurrency, ring_size = _async_geometry(cfg)
    dev = resolve_device(device)
    (kloop, data, test, params, opt, opt_state, pop, sim_steps, up_bytes,
     energy_model, model_bytes) = _fused_setup(cfg, dev)
    sel_state = SelectorState.create(cfg.selector).canonical(dev)
    n = pop.n
    # per-client start params: each completer trains from the version it
    # downloaded, so staleness is real
    local_train = _cohort_train_fn(cfg.model, cfg.local_steps,
                                   cfg.batch_size, cfg.client_lr,
                                   cfg.fedprox_mu, cfg.compression,
                                   cfg.compression_sparsity, params_axis=0)
    init_fill, engine_step = _async_engine(cfg, energy_model, sim_steps,
                                           model_bytes, up_bytes)
    test_acc_fn = _accuracy_fn(cfg.model, test)
    refill = torch.ones((), dtype=torch.bool, device=dev)

    meta = _async_train_meta(cfg, "train-async-host")
    ck = _make_checkpointer(cfg.checkpoint_path, cfg.checkpoint_every,
                            cfg.rounds, meta)
    start = 0
    if cfg.resume_from:
        templates = {"params": params, "opt_state": opt_state, "pop": pop,
                     "st": sel_state,
                     "astate": AsyncEventState.create(n, dev),
                     "ring": _ring_create(params, ring_size),
                     "slot_rank": torch.zeros(n, dtype=torch.int32,
                                              device=dev),
                     "krech": kloop, "kloop": kloop}
        with setup_transfers():     # checkpoint leaves move to the device
            start, state, saved, _ = load_engine_checkpoint(
                cfg.resume_from, templates, expect_meta=meta)
        params, opt_state, pop = (state["params"], state["opt_state"],
                                  state["pop"])
        sel_state, astate, ring = state["st"], state["astate"], state["ring"]
        slot_rank = state["slot_rank"].cpu().numpy().copy()
        krech, kloop = state["krech"], state["kloop"]
        hist = FLHistory(**saved["hist"])
        cum_drop = int(saved["cum_drop"])
        last_loss = float(saved["last_loss"])
    else:
        hist = FLHistory()
        hist.init_acc = float(test_acc_fn(params))
        cum_drop = 0
        last_loss = float("nan")
        kloop, krech, sel_state, astate, ring, idx0, chosen0 = _fill(
            init_fill, kloop, params, pop, sel_state, ring_size,
            AsyncEventState.create(n, dev))
        idx0, chosen0 = idx0.cpu().numpy(), chosen0.cpu().numpy()
        slot_rank = np.zeros((n,), np.int32)
        slot_rank[idx0[chosen0]] = np.where(chosen0)[0]

    for agg in range(start + 1, cfg.rounds + 1):
        kloop, ksel, ktrain, krecharge = prng.split(kloop, 4)
        version_before = int(astate.server_version)
        pop, sel_state, astate, flush, (ridx, rchosen) = engine_step(
            ksel, pop, sel_state, astate, refill)
        chosen, cidx = (flush["comp_chosen"].cpu().numpy(),
                        flush["completed"].cpu().numpy())
        succ_m, stale = (flush["succeeded"].cpu().numpy(),
                         flush["staleness"].cpu().numpy())
        aggw = flush["agg_weight"].cpu().numpy()
        cum_drop += int(flush["new_dropouts"])
        b = cidx.shape[0]

        # canonical flush order: (start version, selection-slot rank),
        # masked rows last
        v_eff = np.where(chosen, version_before - stale, _I32_MAX)
        rk = np.where(chosen, slot_rank[cidx], np.arange(b))
        order = np.lexsort((rk, v_eff))
        cidx_s, chosen_s, succ_s = cidx[order], chosen[order], succ_m[order]
        stale_s, aggw_s, v_s = stale[order], aggw[order], v_eff[order]

        pop = _recharge_step(cfg, pop, krech, float(flush["round_duration"]))
        krech = krecharge

        # version-anchored train keys (the whole flush; compacted below)
        ring_v = ring.version.cpu().numpy()
        ring_succ = ring.succ.cpu().numpy()
        slots = np.argmax(ring_v[None, :] == v_s[:, None], axis=1)
        within = np.zeros((b,), np.int32)
        counts: Dict[int, int] = {}
        for i in range(b):
            within[i] = counts.get(int(v_s[i]), 0)
            if succ_s[i]:
                counts[int(v_s[i])] = within[i] + 1
        key_ix = np.clip(ring_succ[slots] + within, 0, max_concurrency - 1)
        keys_full = _flush_train_keys(
            ring.tkey[torch.as_tensor(slots, device=dev)],
            torch.as_tensor(key_ix, device=dev), max_concurrency)

        pos = np.where(succ_s)[0]
        succ = torch.as_tensor(cidx_s[pos], dtype=torch.long, device=dev)
        skipped = 1
        n_quar = 0
        if len(pos) > 0:
            rows = torch.as_tensor(slots[pos], device=dev)
            start_params = tree_map(lambda r: r[rows], ring.params)
            deltas, per_sample, mean_losses = local_train(
                start_params, data["x"][succ], data["y"][succ],
                keys_full[torch.as_tensor(pos, device=dev)])
            # staleness-damped, sample-weighted mean of the buffered
            # deltas, applied to the CURRENT params; a non-finite delta is
            # quarantined (weight and row zeroed) and the update skipped
            # if nothing finite remains
            weights = pop.n_samples[succ].to(torch.float32) * \
                torch.as_tensor(aggw_s[pos], device=dev)
            finite = finite_rows(deltas)
            w = torch.where(finite, weights, torch.zeros_like(weights))
            agg_delta = weighted_delta(zero_nonfinite_rows(deltas, finite),
                                       w)
            n_quar = int((~finite).sum())
            if bool(finite.any()) and bool(tree_finite(agg_delta)):
                params, opt_state = server_update(params, agg_delta, opt,
                                                  opt_state)
                skipped = 0
            su = stat_utility(per_sample, w)
            pop = scatter_stat_util(pop, succ, finite, su)
            last_loss = float(mean_losses.mean())

        ring = _ring_release(ring, torch.as_tensor(v_s, device=dev),
                             torch.as_tensor(chosen_s, device=dev),
                             torch.as_tensor(succ_s, device=dev))
        # refilled clients download the (possibly just bumped) version
        rchosen_np, ridx_np = rchosen.cpu().numpy(), ridx.cpu().numpy()
        n_refilled = int(rchosen_np.sum())
        ring = _ring_retain(ring, astate.server_version, params,
                            rchosen.sum().to(torch.int32), ktrain)
        rpos = np.where(rchosen_np)[0]
        slot_rank[ridx_np[rpos]] = rpos

        if _trace is not None:
            _trace.append({
                "completed": cidx_s, "comp_chosen": chosen_s,
                "succeeded": succ_s,
                "staleness": np.where(chosen_s, stale_s, 0),
                "agg_weight": aggw_s,
                "start_version": np.where(chosen_s, v_s, 0),
                "selected": ridx_np, "chosen": rchosen_np,
                "server_version": int(astate.server_version),
                "n_inflight": int(astate.in_flight.sum()),
            })

        hist.round.append(agg)
        hist.wall_hours.append(float(astate.server_clock) / 3600.0)
        hist.round_duration.append(float(flush["round_duration"]))
        hist.cum_dropouts.append(cum_drop)
        hist.fairness.append(float(jains_index(pop.times_selected)))
        hist.participation.append(float(succ_s[chosen_s].mean())
                                  if chosen_s.any() else 0.0)
        hist.mean_battery.append(float(pop.battery_pct.mean()))
        hist.train_loss.append(last_loss)
        hist.retries.append(0)      # transient faults are sync-only
        hist.quarantined.append(n_quar)
        hist.update_skipped.append(skipped)
        # cumulative joules of the event state's ledger (charged at
        # completion; admission counted the in-flight commitments, so this
        # never exceeds the budget)
        hist.energy_spent_j.append(float(astate.spent_j))
        if hist.budget_exhausted_round is None \
                and int(astate.exhausted_round) > 0:
            hist.budget_exhausted_round = int(astate.exhausted_round)
        _record_test_acc(hist, cfg, agg, params, test_acc_fn)
        if verbose and agg % 10 == 0:
            print(f"[{cfg.selector.kind}/async] agg={agg} "
                  f"acc={hist.test_acc[-1]:.3f} loss={last_loss:.3f} "
                  f"drop={cum_drop} fair={hist.fairness[-1]:.3f} "
                  f"wall={hist.wall_hours[-1]:.2f}h stale_max="
                  f"{int(stale_s.max()) if chosen_s.any() else 0}")
        if ck and ck.due(agg):
            ck.save(agg,
                    {"params": params, "opt_state": opt_state, "pop": pop,
                     "st": sel_state, "astate": astate, "ring": ring,
                     "slot_rank": torch.as_tensor(slot_rank, device=dev),
                     "krech": krech, "kloop": kloop},
                    {"hist": hist.as_dict(), "cum_drop": cum_drop,
                     "last_loss": last_loss})
        # population exhausted: nothing in flight and nothing refillable
        if not chosen_s.any() and n_refilled == 0 \
                and not bool(astate.in_flight.any()):
            break
    return hist


# ------------------------------------------------------ the fused engine
# The aggregation above as one step over tensors with no host read; on the
# scheduled aggregations an eval step follows. The flush trains at its
# full width from the ring (masked rows ride along with weight exactly
# 0), which the host loop's compacted training matches within float
# tolerance; integer and index outputs are equal.
#
# The step runs over a ``clients`` mesh (``launch/mesh.py``; one shard for
# run_fl_async_scanned), the reference's ``_sharded_async_fused_runner``:
# the event step shard-local (``make_async_round_engine`` with the mesh),
# the selection ranks held in shard blocks and gathered from their owner
# for the canonical order, the flush's data reassembled by one-owner
# sums, the flush axis padded to a multiple of the shard count and split
# evenly (shard i trains rows [i*b_per, (i+1)*b_per)), each shard's
# weighted partial delta summed over the mesh, and the server update, the
# snapshot ring and the eval on replicated state. The flush, refill and
# version columns are the same on any mesh; the aggregate is a float32
# reduction reordered by shard, so the parameters and what follows them
# agree within a tolerance across shard counts.

_ASYNC_CARRY = ("params", "opt_state", "pop", "st", "astate", "ring",
                "slot_rank", "krech", "kloop", "last_acc")


def _async_history(cfg: FLConfig, init_acc: float,
                   traj: Dict[str, np.ndarray]) -> FLHistory:
    """:class:`FLHistory` from an async fused trajectory. As the host
    loop: ``wall_hours`` reads the engine's float32 ``server_clock``,
    participation is per flush (succeeded over chosen), train_loss the
    float32 mean over the compacted successful rows, and the history is
    cut where the host loop breaks (nothing flushed, refilled or in
    flight; the fused engine runs inert aggregations past it)."""
    flushed = np.asarray(traj["comp_chosen"]).sum(axis=1)
    refilled = np.asarray(traj["chosen"]).sum(axis=1)
    done = (flushed == 0) & (refilled == 0) & \
        (np.asarray(traj["n_inflight"]) == 0)
    r_end = int(np.argmax(done)) + 1 if done.any() else done.shape[0]

    hist = FLHistory(init_acc=init_acc)
    hist.round = list(range(1, r_end + 1))
    hist.wall_hours = [float(x) / 3600.0
                       for x in np.asarray(traj["server_clock"])[:r_end]]
    hist.round_duration = [float(x) for x in
                           np.asarray(traj["round_duration"])[:r_end]]
    hist.cum_dropouts = [int(x) for x in np.cumsum(
        np.asarray(traj["new_dropouts"]))[:r_end]]
    succ_mask = np.asarray(traj["succeeded"])
    n_succ = succ_mask.sum(axis=1).astype(np.float64)
    hist.participation = [float(s / c) if c > 0 else 0.0
                          for s, c in zip(n_succ[:r_end],
                                          flushed[:r_end].astype(np.float64))]
    slot_losses = np.asarray(traj["slot_losses"])
    last_loss = float("nan")
    for r in range(r_end):
        m = succ_mask[r]
        if m.any():
            last_loss = float(torch.from_numpy(slot_losses[r][m]).mean())
        hist.train_loss.append(last_loss)
    for name in ("test_acc", "fairness", "mean_battery", "energy_spent_j"):
        setattr(hist, name,
                [float(x) for x in np.asarray(traj[name])[:r_end]])
    hist.retries = [0] * r_end
    for name in ("quarantined", "update_skipped"):
        setattr(hist, name, [int(x) for x in np.asarray(traj[name])[:r_end]])
    last = int(np.asarray(traj["budget_exhausted"])[:r_end][-1])
    hist.budget_exhausted_round = last if last > 0 else None
    return hist


def _async_fused_runner(cfg: FLConfig, energy_model, sim_steps: int,
                        model_bytes: float, up_bytes, opt, mesh,
                        data_x, data_y, test_x, test_y):
    """The fused engine on the ``clients`` ``mesh``: ``(fill, agg_fn,
    eval_fn)``, the population and ``data_x``/``data_y`` in shard blocks
    ``(S, n_loc, ...)``. ``fill(kloop, params, opt_state, pop, st,
    last_acc)`` primes the slots (eagerly, once) and returns the carry, a
    dict laid out as ``_ASYNC_CARRY`` (the event state and the selection
    ranks in shard blocks); ``agg_fn`` and ``eval_fn`` are steps
    ``fn(carry, ctr) -> (carry, outs)`` (``federated/replay.py``)."""
    b_width, max_concurrency, ring_size = _async_geometry(cfg)
    cohort = _cohort_train_fn(cfg.model, cfg.local_steps, cfg.batch_size,
                              cfg.client_lr, cfg.fedprox_mu, cfg.compression,
                              cfg.compression_sparsity, params_axis=0)
    n_real = cfg.n_clients
    init_fill, step = _async_engine(cfg, energy_model, sim_steps,
                                    model_bytes, up_bytes, mesh, n_real)
    eval_acc = _accuracy_fn(cfg.model, {"x": test_x, "y": test_y})
    S, n_loc = data_y.shape[:2]
    split = _SlotSplit(b_width, mesh, S)    # the flush rows over the mesh

    def fill(kloop, params, opt_state, pop, st, last_acc):
        dev = pop.device
        kloop, krech, st, astate, ring, idx0, chosen0 = _fill(
            init_fill, kloop, params, pop, st, ring_size,
            _astate_put(AsyncEventState.create(n_real, dev), mesh))
        slot_rank = _slot_ranks(torch.zeros((S, n_loc), dtype=torch.int32,
                                            device=dev), idx0, chosen0, mesh)
        return dict(params=params, opt_state=opt_state, pop=pop, st=st,
                    astate=astate, ring=ring, slot_rank=slot_rank,
                    krech=krech, kloop=kloop, last_acc=last_acc)

    def agg_fn(carry, ctr):
        (params, opt_state, pop, st, astate, ring, slot_rank, krech, kloop,
         last_acc) = (carry[k] for k in _ASYNC_CARRY)
        dev = pop.device
        kloop, ksel, ktrain, krecharge = prng.split(kloop, 4).unbind(-2)
        version_before = astate.server_version
        pop, st, astate, flush, (ridx, rchosen) = step(
            ksel, pop, st, astate, torch.ones((), dtype=torch.bool,
                                              device=dev))
        # the completers' selection ranks, read from their owner before the
        # refill's ranks are written
        perm, v_s = _canonical_order(version_before, flush, _slot_gather(
            slot_rank, flush["completed"], flush["comp_chosen"], mesh,
            dtype=torch.int32))
        cidx_s = flush["completed"][perm].long()
        chosen_s, succ_s = flush["comp_chosen"][perm], flush["succeeded"][perm]
        stale_s, aggw_s = flush["staleness"][perm], flush["agg_weight"][perm]
        pop = _recharge_device(cfg, pop, krech, flush["round_duration"],
                               mesh, n_real)
        krech = krecharge
        # every flush row trains from the ring slot of the version it
        # downloaded, with its version-anchored success-rank key
        slot_i = _ring_lookup(ring, v_s)
        start_params = tree_map(lambda r: r[slot_i], ring.params)
        key_ix = torch.clamp(ring.succ[slot_i]
                             + _within_version_rank(v_s, succ_s),
                             0, max_concurrency - 1)
        keys = _flush_train_keys(ring.tkey[slot_i], key_ix, max_concurrency)
        # the flush's data: one shard owns each row's client
        own, loc = _slot_owner(cidx_s, mesh.bases(n_loc, dev), n_loc)
        deltas, per_sample, mean_losses = cohort(
            tree_map(split.local, start_params),
            split.local(split.owned(data_x, own, loc)),
            split.local(split.owned(data_y, own, loc)), split.local(keys))
        # quarantine on this process's rows, gathered back in flush order
        fin_loc = finite_rows(deltas)
        deltas = zero_nonfinite_rows(deltas, fin_loc)
        fin = split.whole(fin_loc)
        good = succ_s & fin
        w = torch.where(good, _slot_gather(pop.n_samples, cidx_s, chosen_s,
                                           mesh) * aggw_s,
                        torch.zeros_like(aggw_s))
        agg = split.weighted_delta(deltas, w)
        new_params, new_opt = server_update(params, agg, opt, opt_state)
        ok = good.any() & tree_finite(agg)
        params = tree_map(lambda a, b: torch.where(ok, a, b), new_params,
                          params)
        opt_state = tree_map(lambda a, b: torch.where(ok, a, b), new_opt,
                             opt_state)
        su = split.whole(stat_utility(per_sample, split.local(w)))
        losses = split.whole(mean_losses)
        pop = pop.replace(stat_util=scatter_drop_rows(pop.stat_util, loc,
                                                      own & good, su))
        # ring turnover: the flushed holders release, the refill batch
        # retains the (possibly just bumped) version
        ring = _ring_release(ring, v_s, chosen_s, succ_s)
        ring = _ring_retain(ring, astate.server_version, params,
                            rchosen.sum().to(torch.int32), ktrain)
        slot_rank = _slot_ranks(slot_rank, ridx, rchosen, mesh)
        zero_i = torch.zeros_like(v_s)
        out = {
            "completed": cidx_s.to(torch.int32),
            "comp_chosen": chosen_s,
            "succeeded": succ_s,
            "staleness": torch.where(chosen_s, stale_s, zero_i),
            "agg_weight": aggw_s,
            "start_version": torch.where(chosen_s, v_s, zero_i),
            "selected": ridx.to(torch.int32),
            "chosen": rchosen,
            "round_duration": flush["round_duration"],
            "new_dropouts": flush["new_dropouts"],
            "server_clock": astate.server_clock,
            "server_version": astate.server_version,
            "n_inflight": asum(astate.in_flight, mesh).to(torch.int32),
            "mean_battery": asum(pop.battery_pct, mesh) / n_real,
            "fairness": jains_index(pop.times_selected, mesh, n_real),
            "slot_losses": torch.where(succ_s, losses,
                                       torch.zeros_like(losses)),
            # the last evaluation; the eval step overwrites it where it runs
            "test_acc": last_acc,
            "quarantined": (succ_s & ~fin).sum().to(torch.int32),
            "update_skipped": (~ok).to(torch.int32),
            "energy_spent_j": astate.spent_j,
            "budget_exhausted": astate.exhausted_round,
        }
        return dict(params=params, opt_state=opt_state, pop=pop, st=st,
                    astate=astate, ring=ring, slot_rank=slot_rank,
                    krech=krech, kloop=kloop, last_acc=last_acc), out

    def eval_fn(carry, ctr):
        acc = eval_acc(carry["params"])
        return dict(carry, last_acc=acc), {"test_acc": acc}

    return fill, agg_fn, eval_fn


def _async_fused_engine(cfg: FLConfig, dev: torch.device, mesh):
    """The fused async engine's steps and fresh carry for ``cfg`` on
    ``dev`` over the ``clients`` ``mesh``: ``((agg_fn, eval_fn), carry0)``,
    the population and the clients' data in shard blocks."""
    _check_async_cfg(cfg)
    with setup_transfers():     # one-time host-to-device materialisation
        (kloop, data, test, params, opt, opt_state, pop, sim_steps,
         up_bytes, energy_model, model_bytes) = _fused_setup(cfg, dev)
        if "t" in opt_state:      # the step count rides in the graph too
            opt_state = dict(opt_state, t=opt_state["t"].to(dev))
        fill, agg_fn, eval_fn = _async_fused_runner(
            cfg, energy_model, sim_steps, model_bytes, up_bytes, opt, mesh,
            shard_clients(data["x"], mesh), shard_clients(data["y"], mesh),
            test["x"], test["y"])
        acc0 = _accuracy_fn(cfg.model, test)(params)
        carry0 = fill(kloop, params, opt_state,
                      population_sharding(mesh)(pop),
                      SelectorState.create(cfg.selector).canonical(dev),
                      acc0)
    return (agg_fn, eval_fn), carry0


def _run_async_fused(cfg: FLConfig, verbose: bool, device: DeviceLike, mesh,
                     capture: Optional[dict]) -> FLHistory:
    steps, carry0 = _async_fused_engine(cfg, resolve_device(device), mesh)
    hist = _run_fused_elastic(cfg, steps, carry0,
                              meta=_async_train_meta(cfg, "train-async"),
                              history_fn=_async_history, capture=capture,
                              mesh=mesh)
    if verbose:
        _print_fused_history(cfg, hist)
    return hist


def run_fl_async_scanned(cfg: FLConfig, verbose: bool = False,
                         device: DeviceLike = None,
                         _capture: Optional[dict] = None) -> FLHistory:
    """:func:`run_fl_async` with every aggregation one step on the device
    and no host read inside it (flush, stale-start cohort SGD from the
    snapshot ring, damped aggregation, server update, refill; an eval step
    on the scheduled aggregations): on the card each step is captured once
    in a CUDA graph and replayed, on the CPU it runs eagerly. It is
    :func:`run_fl_async_sharded` on a mesh of one shard.

    The host loop is the oracle: flush, refill and version trajectories
    equal index for index, the damping weights bit for bit, the history's
    floats within float tolerance. ``cfg.checkpoint_path``,
    ``checkpoint_every`` and ``resume_from`` split the run into segments
    (``"train-async"`` family); the ring and the RNG chain ride in the
    carry, so segmented and resumed runs equal the uninterrupted one
    bitwise. ``_capture`` (tests only): a dict that receives the whole
    trajectory under ``"traj"``."""
    from repro_torch.launch.mesh import ClientMesh

    return _run_async_fused(cfg, verbose, device, ClientMesh(1), _capture)


def run_fl_async_sharded(cfg: FLConfig, verbose: bool = False, mesh=None,
                         n_shards: Optional[int] = None,
                         device: DeviceLike = None,
                         _capture: Optional[dict] = None) -> FLHistory:
    """:func:`run_fl_async_scanned` over a ``clients`` mesh (``mesh``, or
    one of ``n_shards`` shards from ``launch/mesh.py::make_client_mesh``):
    the population, its data and the event state in shard blocks, the
    snapshot ring replicated, the flush's local SGD split evenly over the
    shards and their weighted deltas summed. Each aggregation is one step
    with no host read, replayed from a CUDA graph on the card.

    ``run_fl_async_scanned`` (one shard) is the oracle: the flush, refill
    and version columns, dropouts, durations and participation equal;
    parameters, accuracy, loss, battery and fairness within float32
    reduction order. Its ``"train-async"`` snapshots hold the population,
    the event state and the selection ranks trimmed to the real clients,
    so they resume under any shard count and in ``run_fl_async_scanned``,
    and the other way round; rank 0 of a process-group mesh writes
    them."""
    from repro_torch.launch.mesh import make_client_mesh

    return _run_async_fused(
        cfg, verbose, device,
        make_client_mesh(n_shards) if mesh is None else mesh, _capture)
