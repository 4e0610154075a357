"""Restart parity of the checkpointed engines, on the CUDA card unless
``--device cpu``.

Kill-at-round-r semantics: every engine with elastic knobs
(``checkpoint_path`` / ``checkpoint_every`` / ``resume_from``) must give,
from a round-r snapshot, the trajectory of the uninterrupted run bit for
bit: the snapshot carries the whole carry (parameters, optimizer state,
population, selector state, event state, RNG chain), so a crash between
rounds loses nothing but wall time. The sharded engines run on a
``clients`` mesh of ``--devices D`` virtual shards (``launch/mesh.py``;
one process, one device), or over the ranks of an initialised
``torch.distributed`` group.

The default matrix drives the round engines (selection, energy and
battery, no training):

  - ``run_rounds_scanned`` and ``run_rounds_sharded`` resume parity for
    every selector kind (eafl / oort / eafl-epj / random), and a leg with
    injected faults, whose snapshot must refuse a resume under another
    fault configuration (faults are part of a run's identity);
  - ``run_async_scanned`` and ``run_async_sharded`` resume parity for eafl
    and random (the in-flight event state rides in the snapshot);
  - the corruption smoke: a truncated, a bit-flipped and an empty
    snapshot, and one of another run (another ``k``), must each raise
    ``CheckpointError`` (never load wrong state), and ``checkpoint_every``
    without a path a ``ValueError``.

``--train`` runs the training matrix instead (``--only sync|async``
restricts it to one aggregation family):

  - ``run_fl_scanned`` resume parity for every kind, the host loop
    ``run_fl`` and ``run_fl_sharded`` (eafl, and a recharging random run)
    resuming their own snapshots bitwise;
  - ``run_fl_sharded`` resuming a snapshot of ``run_fl_scanned`` (the
    shared ``train-sync`` family; the trimmed population re-padded to the
    mesh): the bookkeeping exact, the float statistics within 5e-4;
  - faults (crash with retries, straggle, corrupt updates): the fused
    engine's resume bitwise, retries and quarantines drawn, no injected
    NaN reaching ``test_acc``, and the host loop against the fused engine;
  - the async family: ``run_fl_async_scanned`` resume parity (the snapshot
    ring, the event state and the selection ranks in the carry), the host
    event loop's own resume parity and the host loop against the fused
    engine, ``run_fl_async_sharded`` resuming its own snapshot bitwise,
    and resuming the fused engine's (the shared ``train-async`` family)
    within 5e-4.

The host loop against the fused engine is held where the reference's own
engines agree (``ROADMAP.md``, "Reference caveats"), at the tolerances of
``tests/test_torch_training_engines.py``: integers exact, fairness,
participation, wall hours, battery, joules and durations within rtol
1e-5, loss and accuracy within rtol 2e-3 (the fused engine trains its
masked full-width cohort, the host loop the compacted one). Cross-engine
resumes on a card run cuDNN's deterministic float32 algorithms.

Exits non-zero at the first mismatch; prints ``elastic parity OK`` or
``elastic training parity OK`` when the matrix passes.

  python -m repro_torch.launch.elastic_check --devices 2 [--device cpu]
  python -m repro_torch.launch.elastic_check --devices 2 --train [--only async]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.checkpoint import (CheckpointError, checkpoint_path_for,
                                    tree_flatten)
from repro_torch.core.clients import make_population
from repro_torch.core.energy import EnergyModel
from repro_torch.core.selection import SelectorConfig, SelectorState
from repro_torch.device import deterministic_float32, resolve_device
from repro_torch.federated.faults import FaultConfig
from repro_torch.federated.simulation import (run_async_scanned,
                                              run_async_sharded,
                                              run_rounds_scanned,
                                              run_rounds_sharded)
from repro_torch.launch.mesh import make_client_mesh

ALL_KINDS = ("eafl", "oort", "eafl-epj", "random")

# every FLHistory field the engines fill: restart parity holds for the
# whole history, the fault and elasticity accounting included
HIST_FIELDS = ("round", "wall_hours", "round_duration", "test_acc",
               "train_loss", "cum_dropouts", "fairness", "participation",
               "mean_battery", "retries", "quarantined", "update_skipped",
               "energy_spent_j")
# exact across shard counts; the rest within the reduction-order atol
EXACT_FIELDS = ("round", "cum_dropouts", "participation", "retries",
                "quarantined", "update_skipped", "round_duration",
                "wall_hours")
# the host loop against the fused engine (tests/test_torch_training_
# engines.py): integers exact, these within rtol 1e-5, the rest 2e-3
ENGINE_EXACT = ("round", "cum_dropouts", "retries", "quarantined",
                "update_skipped")
ENGINE_CLOSE = ("fairness", "participation", "wall_hours", "mean_battery",
                "energy_spent_j", "round_duration")


def _leaf(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tree_equal(label, t1, t2):
    """Bit-for-bit equality of two trees (trajectory dicts, populations,
    event states): the same leaves, dtypes and values (NaN equal NaN)."""
    l1, l2 = tree_flatten(t1)[0], tree_flatten(t2)[0]
    if len(l1) != len(l2):
        raise AssertionError(f"{label}: leaf count {len(l1)} != {len(l2)}")
    for i, (a, b) in enumerate(zip(l1, l2)):
        a, b = _leaf(a), _leaf(b)
        same = a.shape == b.shape and a.dtype == b.dtype and (
            np.array_equal(a, b, equal_nan=True)
            if np.issubdtype(a.dtype, np.inexact) else np.array_equal(a, b))
        if not same:
            raise AssertionError(f"{label}: leaf {i} diverged\n{a}\n{b}")


def _assert_hist_equal(label, ref, got, float_atol=None):
    """FLHistory equality: bitwise by default; ``float_atol`` relaxes the
    float model statistics for a resume across shard counts (the spent
    joules to rtol 1e-6), the selection, dropout and fault bookkeeping
    staying exact."""
    for f in HIST_FIELDS:
        a = np.asarray(getattr(ref, f), dtype=np.float64)
        b = np.asarray(getattr(got, f), dtype=np.float64)
        if a.shape != b.shape:
            raise AssertionError(f"{label}: {f} length diverged")
        nan = np.isnan(a) & np.isnan(b)
        if float_atol is not None and f == "energy_spent_j":
            # thousands of joules summed over the mesh: an ulp is 1e-3
            np.testing.assert_allclose(a, b, rtol=1e-6,
                                       err_msg=f"{label}: {f}")
        elif float_atol is not None and f not in EXACT_FIELDS:
            np.testing.assert_allclose(a[~nan], b[~nan], atol=float_atol,
                                       rtol=0, err_msg=f"{label}: {f}")
        elif not np.array_equal(a[~nan], b[~nan]):
            raise AssertionError(f"{label}: {f} diverged\n{a}\n{b}")
    if ref.budget_exhausted_round != got.budget_exhausted_round:
        raise AssertionError(f"{label}: budget_exhausted_round diverged")
    ia, ib = float(ref.init_acc), float(got.init_acc)
    if not (ia == ib or (np.isnan(ia) and np.isnan(ib))):
        raise AssertionError(f"{label}: init_acc {ia} != {ib}")


def _assert_engines_agree(label, fused, host):
    """The host loop against the fused engine at the fused engine's own
    tolerances (module docstring)."""
    for f in ENGINE_EXACT:
        if getattr(fused, f) != getattr(host, f):
            raise AssertionError(f"{label}: {f} diverged")
    if fused.budget_exhausted_round != host.budget_exhausted_round:
        raise AssertionError(f"{label}: budget_exhausted_round diverged")
    for f in ENGINE_CLOSE + ("train_loss", "test_acc"):
        np.testing.assert_allclose(
            getattr(fused, f), getattr(host, f),
            rtol=1e-5 if f in ENGINE_CLOSE else 2e-3, err_msg=f"{label}: "
                                                              f"{f}")
    np.testing.assert_allclose(fused.init_acc, host.init_acc, rtol=2e-3,
                               err_msg=f"{label}: init_acc")
    print(f"  {label}: OK")


# --------------------------------------------------------------- engines
def _engine_pop(key, n):
    pop = make_population(key, n)
    ks = prng.split(prng.fold_in(key, 1), 2)
    return pop.replace(stat_util=prng.uniform(ks[0], (n,)) * 10,
                       explored=prng.bernoulli(ks[1], 0.6, (n,)))


def _check_engine_resume(label, runner, tmp, key, cfg, pop, resume_at,
                         rounds, every, **kw):
    """The plain run, the checkpointed run and the run resumed from the
    round-``resume_at`` snapshot: the final population, selector state and
    whole trajectory bitwise equal. Returns the snapshot's path."""
    ckdir = os.path.join(tmp, label.replace(" ", "_"))
    os.makedirs(ckdir)
    path = os.path.join(ckdir, "ck_{round}.ckpt")
    p1, s1, t1 = runner(key, cfg, pop, SelectorState.create(cfg),
                        rounds=rounds, **kw)
    p2, s2, t2 = runner(key, cfg, pop, SelectorState.create(cfg),
                        rounds=rounds, checkpoint_path=path,
                        checkpoint_every=every, **kw)
    _assert_tree_equal(f"{label} elastic-vs-plain trajectory", t1, t2)
    _assert_tree_equal(f"{label} elastic-vs-plain population", p1, p2)
    ck = checkpoint_path_for(path, resume_at)
    if not os.path.exists(ck):
        raise AssertionError(f"{label}: no snapshot at round {resume_at}")
    p3, s3, t3 = runner(key, cfg, pop, SelectorState.create(cfg),
                        rounds=rounds, resume_from=ck, **kw)
    _assert_tree_equal(f"{label} resumed trajectory", t1, t3)
    _assert_tree_equal(f"{label} resumed population", p1, p3)
    for st in (s2, s3):
        _assert_tree_equal(f"{label} selector state", s1, st)
    print(f"  {label}: OK")
    return ck


def _expect_refusal(label, exc, fn):
    try:
        fn()
    except exc:
        print(f"  {label}: OK")
        return
    raise AssertionError(f"{label}: accepted without an error")


def _check_corruption(tmp, key, cfg, pop, good_ck, rounds, **kw):
    """A damaged or mismatched snapshot must refuse to load: resuming
    from wrong state is the one failure that must never pass silently."""
    def resume(path, c=cfg):
        return lambda: run_rounds_scanned(key, c, pop,
                                          SelectorState.create(cfg),
                                          rounds=rounds, resume_from=path,
                                          **kw)

    with open(good_ck, "rb") as f:
        raw = f.read()
    damaged = {"truncated": raw[:len(raw) // 2],
               "bit-flip": raw[:len(raw) // 2]
               + bytes([raw[len(raw) // 2] ^ 0xFF]) + raw[len(raw) // 2 + 1:],
               "empty": b""}
    for name, body in damaged.items():
        path = os.path.join(tmp, f"{name}.ckpt")
        with open(path, "wb") as f:
            f.write(body)
        _expect_refusal(f"corruption {name}", CheckpointError, resume(path))
    # the same bytes under another run's identity (k)
    _expect_refusal("corruption meta-mismatch", CheckpointError,
                    resume(good_ck, dataclasses.replace(cfg, k=cfg.k + 1)))
    # checkpoint_every without a path has nowhere to write
    _expect_refusal("corruption every-without-path", ValueError,
                    lambda: run_rounds_scanned(
                        key, cfg, pop, SelectorState.create(cfg),
                        rounds=rounds, checkpoint_every=2, **kw))


def check_engines(mesh, dev, tmp, n: int = 200, rounds: int = 8) -> None:
    """The round engines' matrix (module docstring) on ``mesh``."""
    key = prng.PRNGKey(11, dev)
    pop = _engine_pop(key, n)
    kw = dict(energy_model=EnergyModel(), model_bytes=85e6, local_steps=400,
              batch_size=20)
    every, resume_at = 2, max((rounds // 2) // 2 * 2, 2)

    good_ck = None
    for kind in ALL_KINDS:
        cfg = SelectorConfig(kind, k=10)
        ck = _check_engine_resume(f"sync scanned {kind}",
                                  run_rounds_scanned, tmp, key, cfg, pop,
                                  resume_at, rounds, every, **kw)
        good_ck = good_ck or ck
        _check_engine_resume(f"sync sharded {kind}", run_rounds_sharded,
                             tmp, key, cfg, pop, resume_at, rounds, every,
                             mesh=mesh, **kw)

    fcfg = FaultConfig(seed=5, crash_prob=0.2, max_retries=2,
                       straggle_prob=0.15, corrupt_prob=0.1)
    cfg = SelectorConfig("eafl", k=10)
    fck = _check_engine_resume("sync scanned faults", run_rounds_scanned,
                               tmp, key, cfg, pop, resume_at, rounds, every,
                               faults=fcfg, deadline_s=4000.0, **kw)
    _expect_refusal("fault-config mismatch refused", CheckpointError,
                    lambda: run_rounds_scanned(
                        key, cfg, pop, SelectorState.create(cfg),
                        rounds=rounds, resume_from=fck,
                        faults=dataclasses.replace(fcfg, seed=6),
                        deadline_s=4000.0, **kw))

    akw = dict(buffer_size=3, max_concurrency=9, staleness_power=0.5, **kw)
    for kind in ("eafl", "random"):
        cfg = SelectorConfig(kind, k=10)
        _check_engine_resume(f"async scanned {kind}", run_async_scanned,
                             tmp, key, cfg, pop, resume_at, rounds, every,
                             **akw)
        _check_engine_resume(f"async sharded {kind}", run_async_sharded,
                             tmp, key, cfg, pop, resume_at, rounds, every,
                             mesh=mesh, **akw)

    _check_corruption(tmp, key, SelectorConfig("eafl", k=10), pop, good_ck,
                      rounds, **kw)


# -------------------------------------------------------------- training
def _check_train_resume(label, runner, tmp, base_cfg, resume_at, every,
                        float_atol=None, guard=None):
    """The checkpointed run and the run resumed from the round-
    ``resume_at`` snapshot against the plain run: bitwise (``float_atol``
    relaxes the float statistics). Returns the plain history and the
    snapshot's path."""
    ckdir = os.path.join(tmp, label.replace(" ", "_"))
    os.makedirs(ckdir)
    path = os.path.join(ckdir, "ck_{round}.ckpt")
    ref = runner(base_cfg)
    elastic = runner(dataclasses.replace(base_cfg, checkpoint_path=path,
                                         checkpoint_every=every))
    _assert_hist_equal(f"{label} elastic-vs-plain", ref, elastic,
                       float_atol=float_atol)
    ck = checkpoint_path_for(path, resume_at)
    if not os.path.exists(ck):
        raise AssertionError(f"{label}: no snapshot at round {resume_at}")
    resumed = runner(dataclasses.replace(base_cfg, resume_from=ck))
    _assert_hist_equal(f"{label} resume", ref, resumed,
                       float_atol=float_atol)
    if guard is not None:
        guard(ref)
    print(f"  {label}: OK")
    return ref, ck


def check_training(mesh, dev, tmp, rounds: int = 8,
                   only: str = "all") -> None:
    """The training matrix (module docstring) on ``mesh``."""
    from repro_torch.configs.paper_resnet_speech import reduced
    from repro_torch.federated.server import FLConfig

    def cfg(kind, **kw):
        base = dict(selector=SelectorConfig(kind, k=4), n_clients=24,
                    rounds=rounds, local_steps=3, batch_size=8,
                    samples_per_client=24, eval_every=4, eval_samples=70,
                    model=reduced(), input_hw=16)
        base.update(kw)
        return FLConfig(**base)

    every, resume_at = 3, 3
    with deterministic_float32(dev):
        if only != "async":
            _sync_training(mesh, dev, tmp, cfg, resume_at, every)
        if only != "sync":
            _async_training(mesh, dev, tmp, cfg, resume_at, every)


def _sync_training(mesh, dev, tmp, cfg, resume_at, every):
    from repro_torch.federated.server import (run_fl, run_fl_scanned,
                                              run_fl_sharded)

    def scanned(c):
        return run_fl_scanned(c, device=dev)

    def sharded(c):
        return run_fl_sharded(c, mesh=mesh, device=dev)

    refs = {kind: _check_train_resume(f"train scanned {kind}", scanned, tmp,
                                      cfg(kind), resume_at, every)
            for kind in ALL_KINDS}
    # the host loop's snapshot carries its Python-side history too
    _check_train_resume("train host eafl",
                        lambda c: run_fl(c, device=dev), tmp, cfg("eafl"),
                        resume_at, every)
    # the sharded engine resuming its own snapshot: bitwise (the same
    # reduction order)
    _check_train_resume("train sharded eafl", sharded, tmp, cfg("eafl"),
                        resume_at, every)
    _check_train_resume("train sharded recharge", sharded, tmp,
                        cfg("random", recharge_pct_per_hour=40.0,
                            plugged_frac=0.5, init_battery_low=12.0,
                            init_battery_high=30.0), resume_at, every)
    # across engines: the sharded engine resuming the fused engine's
    # snapshot (the shared "train-sync" family, re-padded to this mesh)
    ref, ck = refs["eafl"]
    _assert_hist_equal("train cross-engine scanned->sharded", ref,
                       sharded(dataclasses.replace(cfg("eafl"),
                                                   resume_from=ck)),
                       float_atol=5e-4)
    print("  train cross-engine scanned->sharded: OK")

    # faults: the fused engine's resume bitwise, the leg not vacuous, no
    # injected NaN in the evaluated model; the host loop against it
    fault_cfg = cfg("eafl", faults=FaultConfig(
        seed=3, crash_prob=0.25, max_retries=2, straggle_prob=0.2,
        corrupt_prob=0.3), deadline_s=2000.0, recharge_pct_per_hour=40.0,
        plugged_frac=0.5)

    def guard(h):
        if not sum(h.retries) > 0:
            raise AssertionError("fault leg vacuous: no retry drawn")
        if not sum(h.quarantined) > 0:
            raise AssertionError("fault leg vacuous: no update quarantined")
        if not np.isfinite(np.asarray(h.test_acc, np.float64)).all():
            raise AssertionError("an injected NaN reached test_acc")

    ref, _ = _check_train_resume("train scanned faults", scanned, tmp,
                                 fault_cfg, resume_at, every, guard=guard)
    _assert_engines_agree("train faults host-vs-scanned", ref,
                          run_fl(fault_cfg, device=dev))


def _async_training(mesh, dev, tmp, cfg, resume_at, every):
    from repro_torch.federated.async_server import (run_fl_async,
                                                    run_fl_async_scanned,
                                                    run_fl_async_sharded)

    def sharded(c):
        return run_fl_async_sharded(c, mesh=mesh, device=dev)

    # the whole event carry (snapshot ring, event state, selection ranks)
    # rides in the snapshot and is restored in one pass
    async_cfg = cfg("eafl", buffer_size=3, max_concurrency=6,
                    staleness_power=0.5)
    aref, ack = _check_train_resume(
        "train async-scanned eafl",
        lambda c: run_fl_async_scanned(c, device=dev), tmp, async_cfg,
        resume_at, every)
    host, _ = _check_train_resume("train async host eafl",
                                  lambda c: run_fl_async(c, device=dev), tmp,
                                  async_cfg, resume_at, every)
    _assert_engines_agree("train async host-vs-scanned", aref, host)
    _check_train_resume("train async-sharded eafl", sharded, tmp, async_cfg,
                        resume_at, every)
    # across engines: the sharded engine resuming the fused engine's
    # snapshot (the shared "train-async" family; the trimmed event state
    # and selection ranks re-padded to this mesh)
    _assert_hist_equal("train cross-engine async scanned->sharded", aref,
                       sharded(dataclasses.replace(async_cfg,
                                                   resume_from=ack)),
                       float_atol=5e-4)
    print("  train cross-engine async scanned->sharded: OK")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=(
        "Restart parity of the checkpointed engines (the round engines, or "
        "training with --train) on a clients mesh of --devices virtual "
        "shards."))
    ap.add_argument("--devices", type=int, default=None,
                    help="virtual shards of the clients mesh (default 1)")
    ap.add_argument("--n", type=int, default=200,
                    help="population size of the round engines' matrix")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--train", action="store_true",
                    help="run the training matrix (host, fused and sharded "
                         "engines of both aggregation families) instead of "
                         "the round engines'")
    ap.add_argument("--only", choices=("all", "sync", "async"),
                    default="all",
                    help="with --train: one aggregation family only")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.devices is not None and args.devices < 1:
        ap.error(f"--devices must be at least 1, got {args.devices}")
    dev = resolve_device(args.device)
    mesh = make_client_mesh(args.devices)
    s = mesh.size()
    print(f"device={dev} mesh_shards={s}")
    tmp = tempfile.mkdtemp(prefix="elastic_check_")
    try:
        if args.train:
            check_training(mesh, dev, tmp, max(args.rounds, 8), args.only)
            print(f"elastic training parity OK ({s} shards, {args.only})")
        else:
            check_engines(mesh, dev, tmp, args.n, max(args.rounds, 6))
            print(f"elastic parity OK ({s} shards)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
