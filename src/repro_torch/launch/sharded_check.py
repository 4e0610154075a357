"""Parity of the sharded engines against the single-device ones.

Runs the synchronous parity matrix of the sharded round engine against
the single-device engine on a ``clients`` mesh of ``--devices D`` virtual
shards (``launch/mesh.py``; one process, one device), on the CUDA card
unless ``--device cpu``:

  - every selector kind (eafl / oort / eafl-epj / random), several rounds
    so the selector state moves, on a shard-divisible and a
    non-divisible (padded final shard) population;
  - tie-heavy scores (all-equal utilities: the tie order must be
    index-identical);
  - an all-dropped first shard and an all-dropped population;
  - k larger than a shard's client count;
  - the kernel's per-shard leg (``topk_reward`` with each shard's
    ``index_offset``) against the single-device kernel leg;
  - the R-round trajectory, ``run_rounds_sharded`` against
    ``run_rounds_scanned``, index for index on selected/chosen/succeeded;
  - the async matrix, ``run_async_sharded`` against ``run_async_scanned``
    on the same key: every kind buffered (buffer 3, concurrency 9,
    staleness damping on) and in the sync limit (buffer = concurrency =
    k, power 0); a tight deadline (400 s) that must abandon an arrival;
    a flush in which every client dies (batteries 1-12 %, a loose
    deadline, 1600 local steps). Completion order, staleness, refills,
    the event clocks and the wall clock equal, the damping weights bit
    for bit, the summed statistics and batteries within rtol 1e-6.

``--train`` runs the end-to-end training matrix instead:
``run_fl_sharded`` against ``run_fl_scanned`` (four configurations,
overcommit and recharge among them), exact on the selection, dropout and
duration bookkeeping and within 5e-4 on the float model statistics (the
sharded aggregate sums per-shard partial products, a reordered float32
reduction; on a card both engines run cuDNN's deterministic float32
algorithms for it); it prints ``training parity OK``.

Exits non-zero at the first mismatch; prints ``parity OK`` when the whole
matrix passes.

  python -m repro_torch.launch.sharded_check --devices 8 [--device cpu]
  python -m repro_torch.launch.sharded_check --devices 8 --train
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.clients import make_population
from repro_torch.core.energy import EnergyModel
from repro_torch.core.selection import (SelectorConfig, SelectorState,
                                        _device_select,
                                        make_sharded_select_step)
from repro_torch.device import deterministic_float32, resolve_device
from repro_torch.federated.simulation import (run_async_scanned,
                                              run_async_sharded,
                                              run_rounds_scanned,
                                              run_rounds_sharded)
from repro_torch.launch.mesh import make_client_mesh

ALL_KINDS = ("eafl", "oort", "eafl-epj", "random")


def mixed_pop(key, n):
    """A population with utilities, an explored share and dropouts."""
    pop = make_population(key, n)
    ks = prng.split(prng.fold_in(key, 1), 3)
    return pop.replace(stat_util=prng.uniform(ks[0], (n,)) * 10,
                       explored=prng.bernoulli(ks[1], 0.6, (n,)),
                       dropped=prng.bernoulli(ks[2], 0.08, (n,)))


def _pred(key, n, salt):
    return torch.abs(prng.normal(prng.fold_in(key, salt), (n,))) * 5


def _check_step(label, mesh, cfg, pop, pred, key, rounds=4,
                use_kernel=False):
    """Both paths for several rounds with their own state carries:
    identical indices, chosen masks and selector state."""
    step = make_sharded_select_step(cfg, mesh, pop.n, use_kernel=use_kernel)
    st_ref = SelectorState.create(cfg)
    st_sh = SelectorState.create(cfg)
    for r in range(rounds):
        kr = prng.fold_in(key, 100 + r)
        i1, c1, st_ref = _device_select(kr, cfg, st_ref, pop, pred,
                                        use_kernel)
        i2, c2, st_sh = step(kr, st_sh, pop, pred)
        c1, c2 = c1.cpu().numpy(), c2.cpu().numpy()
        i1, i2 = i1.cpu().numpy(), i2.cpu().numpy()
        if not np.array_equal(c1, c2):
            raise AssertionError(f"{label} r{r}: chosen mask diverged\n"
                                 f"{c1}\n{c2}")
        if not np.array_equal(i1[c1], i2[c2]):
            raise AssertionError(f"{label} r{r}: indices diverged\n"
                                 f"{i1[c1]}\n{i2[c2]}")
        for f in ("epsilon", "pacer_T", "util_ema"):
            a, b = float(getattr(st_ref, f)), float(getattr(st_sh, f))
            if a != b:
                raise AssertionError(f"{label} r{r}: state.{f} {a} != {b}")
    print(f"  {label}: OK")


def check_selection(mesh, dev, n_main: int = 999, rounds: int = 4) -> None:
    """The selection matrix (module docstring) on ``mesh``."""
    s = mesh.size()
    key = prng.PRNGKey(7, dev)
    kernel = dev.type == "cuda"     # the card's exploit leg is the kernel
    for n in (n_main, 1024):
        pop = mixed_pop(key, n)
        pred = _pred(key, n, 2)
        for kind in ALL_KINDS:
            _check_step(f"{kind} n={n}", mesh, SelectorConfig(kind, k=12),
                        pop, pred, key, rounds, kernel)

    n = 1024
    pop = make_population(key, n).replace(
        stat_util=torch.ones(n, device=dev),
        last_duration=torch.ones(n, device=dev),
        battery_pct=torch.full((n,), 80.0, device=dev),
        explored=torch.ones(n, dtype=torch.bool, device=dev),
        last_round=torch.zeros(n, dtype=torch.int32, device=dev))
    pred = torch.full((n,), 3.0, device=dev)
    for kind in ("eafl", "oort", "eafl-epj"):
        cfg = SelectorConfig(kind, k=16, epsilon0=0.0, epsilon_min=0.0)
        _check_step(f"ties {kind}", mesh, cfg, pop, pred, key, 2, kernel)

    pop = mixed_pop(key, n)
    first = pop.replace(
        dropped=torch.arange(n, device=dev) < max(n // s, 1))
    everyone = pop.replace(dropped=torch.ones(n, dtype=torch.bool,
                                              device=dev))
    pred = _pred(key, n, 3)
    for kind in ALL_KINDS:
        cfg = SelectorConfig(kind, k=12)
        _check_step(f"first-shard-dropped {kind}", mesh, cfg, first, pred,
                    key, 2, kernel)
        _check_step(f"all-dropped {kind}", mesh, cfg, everyone, pred, key,
                    2, kernel)

    n = 40                        # 5 clients a shard on 8 shards, k = 12
    pop = mixed_pop(key, n)
    pred = _pred(key, n, 4)
    for kind in ALL_KINDS:
        _check_step(f"k>n_shard {kind}", mesh, SelectorConfig(kind, k=12),
                    pop, pred, key, 2, kernel)

    n = 1000
    pop = mixed_pop(key, n)
    _check_step("kernel eafl", mesh, SelectorConfig("eafl", k=12), pop,
                _pred(key, n, 5), key, 2, use_kernel=True)

    pop = mixed_pop(key, n_main)
    cfg = SelectorConfig("eafl", k=12)
    kw = dict(energy_model=EnergyModel(), model_bytes=85e6, local_steps=400,
              batch_size=20, rounds=6)
    p1, s1, t1 = run_rounds_scanned(key, cfg, pop, SelectorState.create(cfg),
                                    **kw)
    p2, s2, t2 = run_rounds_sharded(key, cfg, pop, SelectorState.create(cfg),
                                    mesh=mesh, **kw)
    for f in ("selected", "chosen", "succeeded", "total_dropped",
              "round_duration"):
        if not np.array_equal(t1[f], t2[f]):
            raise AssertionError(f"scan trajectory diverged on {f}")
    np.testing.assert_allclose(t1["mean_battery"], t2["mean_battery"],
                               rtol=1e-6)
    np.testing.assert_allclose(p1.battery_pct.cpu().numpy(),
                               p2.battery_pct.cpu().numpy(), rtol=1e-6)
    if not torch.equal(p1.dropped, p2.dropped):
        raise AssertionError("scan trajectory: dropped diverged")
    if float(s1.util_ema) != float(s2.util_ema):
        raise AssertionError("scan trajectory: util_ema diverged")
    print("  scan trajectory: OK")


ASYNC_EXACT = ("completed", "comp_chosen", "succeeded", "staleness",
               "selected", "chosen", "fill_selected", "fill_chosen",
               "total_dropped", "n_inflight", "round_duration",
               "server_clock", "agg_weight")


def _check_async(label, mesh, cfg, pop, key, em, rounds=4,
                 buffer_size=None, max_concurrency=None,
                 staleness_power=0.5, deadline_s=None,
                 require_abandoned=False, local_steps=400):
    """``run_async_sharded`` against ``run_async_scanned`` on the same
    key: the event trajectory equal (the wall clock and the damping
    weights bit for bit), the summed statistics, batteries and spent
    joules within rtol 1e-6, the rest of the final event state and the
    selector state equal.
    ``require_abandoned`` keeps a failure case from going vacuous: some
    chosen arrival must have failed (deadline or battery)."""
    kw = dict(energy_model=em, model_bytes=85e6, local_steps=local_steps,
              batch_size=20, rounds=rounds, buffer_size=buffer_size,
              max_concurrency=max_concurrency,
              staleness_power=staleness_power, deadline_s=deadline_s)
    p1, s1, t1 = run_async_scanned(key, cfg, pop, SelectorState.create(cfg),
                                   **kw)
    p2, s2, t2 = run_async_sharded(key, cfg, pop, SelectorState.create(cfg),
                                   mesh=mesh, **kw)
    for f in ASYNC_EXACT:
        a, b = np.asarray(t1[f]), np.asarray(t2[f])
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{label}: async trajectory diverged on "
                                 f"{f}\n{a}\n{b}")
    for f in ("mean_battery", "energy_spent_pct", "energy_spent_j"):
        np.testing.assert_allclose(t1[f], t2[f], rtol=1e-6,
                                   err_msg=f"{label}: {f}")
    np.testing.assert_allclose(p1.battery_pct.cpu().numpy(),
                               p2.battery_pct.cpu().numpy(), rtol=1e-6,
                               err_msg=f"{label}: battery")
    if not torch.equal(p1.dropped, p2.dropped):
        raise AssertionError(f"{label}: dropped diverged")
    e1, e2 = t1["final_event_state"], t2["final_event_state"]
    for f in ("t_done", "start_version", "server_clock", "server_version",
              "exhausted_round"):
        if not torch.equal(getattr(e1, f), getattr(e2, f)):
            raise AssertionError(f"{label}: event state {f} diverged")
    np.testing.assert_allclose(float(e1.spent_j), float(e2.spent_j),
                               rtol=1e-6, err_msg=f"{label}: spent_j")
    for f in ("round", "epsilon", "pacer_T", "util_ema"):
        a, b = float(getattr(s1, f)), float(getattr(s2, f))
        if a != b:
            raise AssertionError(f"{label}: state.{f} {a} != {b}")
    if require_abandoned:
        failed = t1["comp_chosen"] & ~t1["succeeded"]
        if not failed.any():
            raise AssertionError(f"{label}: no arrival was abandoned; the "
                                 f"case is vacuous")
    print(f"  {label}: OK")


def check_async(mesh, dev, n: int = 999, rounds: int = 4) -> None:
    """The async matrix (module docstring) on ``mesh``: the reference's
    cases, on the port's population maker."""
    key = prng.PRNGKey(7, dev)
    em = EnergyModel()
    pop = mixed_pop(key, n).replace(
        dropped=torch.zeros(n, dtype=torch.bool, device=dev))
    kasync = prng.fold_in(key, 6)
    for kind in ALL_KINDS:
        cfg = SelectorConfig(kind, k=10)
        _check_async(f"async buffered {kind}", mesh, cfg, pop, kasync, em,
                     rounds=rounds, buffer_size=3, max_concurrency=9)
        _check_async(f"async sync-limit {kind}", mesh, cfg, pop, kasync, em,
                     rounds=rounds, buffer_size=10, max_concurrency=10,
                     staleness_power=0.0)
    # a tight deadline that abandons arrivals (400 s cuts through this
    # workload's arrival offsets), and a flush in which every client dies
    # (drained batteries under a loose deadline: the duration's fallback
    # and the survivors' re-base clamped at 0)
    _check_async("async tight-deadline eafl", mesh, SelectorConfig("eafl",
                                                                  k=10),
                 pop, kasync, em, rounds=rounds, buffer_size=3,
                 max_concurrency=9, deadline_s=400.0,
                 require_abandoned=True)
    low = make_population(key, 256, init_battery_low=1.0,
                          init_battery_high=12.0).replace(
        stat_util=prng.uniform(prng.fold_in(key, 8), (256,)) * 10)
    _check_async("async flush-dies eafl", mesh, SelectorConfig("eafl", k=8),
                 low, kasync, em, rounds=rounds, buffer_size=2,
                 max_concurrency=8, deadline_s=1e6, require_abandoned=True,
                 local_steps=1600)


def check_training(mesh, dev, rounds: int = 4) -> None:
    """End-to-end training parity: ``run_fl_sharded`` against
    ``run_fl_scanned`` (itself held against the host loop). The selection,
    dropout and duration bookkeeping must be exact; the float model
    statistics within 5e-4. On a card both run float32 convolutions with
    cuDNN's deterministic algorithms (TF32 off), so that the only
    difference left is the sharded aggregate's reduction order: cuDNN's
    default algorithms differ from run to run by more than that, and
    training amplifies it."""
    with deterministic_float32(dev):
        _check_training(mesh, dev, rounds)


def _check_training(mesh, dev, rounds: int) -> None:
    from repro_torch.configs.paper_resnet_speech import reduced
    from repro_torch.federated.server import (FLConfig, run_fl_scanned,
                                              run_fl_sharded)

    def cfg(kind, **kw):
        base = dict(selector=SelectorConfig(kind=kind, k=4), n_clients=24,
                    rounds=rounds, local_steps=3, batch_size=8,
                    samples_per_client=24, eval_every=4, eval_samples=70,
                    model=reduced(), input_hw=16)
        base.update(kw)
        return FLConfig(**base)

    cases = [
        ("eafl", cfg("eafl")),
        ("oort", cfg("oort")),
        # more slots than k: the straggler cap over slot-gathered durations
        ("overcommit", cfg("eafl", overcommit=1.5)),
        # the shards' slices of the recharge draw; pad clients never rejoin
        ("recharge", cfg("random", recharge_pct_per_hour=40.0,
                         plugged_frac=0.5, init_battery_low=12.0,
                         init_battery_high=30.0)),
    ]
    for label, c in cases:
        ref = run_fl_scanned(c, device=dev)
        sh = run_fl_sharded(c, mesh=mesh, device=dev)
        for f in ("cum_dropouts", "participation", "round_duration",
                  "wall_hours"):
            if not np.array_equal(np.asarray(getattr(ref, f)),
                                  np.asarray(getattr(sh, f))):
                raise AssertionError(f"training {label}: {f} diverged")
        for f in ("test_acc", "train_loss", "fairness", "mean_battery"):
            a = np.asarray(getattr(ref, f), dtype=np.float64)
            b = np.asarray(getattr(sh, f), dtype=np.float64)
            nan = np.isnan(a) & np.isnan(b)
            np.testing.assert_allclose(a[~nan], b[~nan], atol=5e-4, rtol=0,
                                       err_msg=f"training {label}: {f}")
        if abs(ref.init_acc - sh.init_acc) > 5e-4:
            raise AssertionError(f"training {label}: init_acc diverged")
        print(f"  training {label}: OK")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=(
        "The parity matrix of the sharded engines (selection, sync and "
        "async, or training with --train) on a clients mesh of --devices "
        "virtual shards."))
    ap.add_argument("--devices", type=int, default=None,
                    help="virtual shards of the clients mesh (default 1)")
    ap.add_argument("--n", type=int, default=999,
                    help="population size of the main matrix (default not "
                         "divisible by 2 or 8)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--train", action="store_true",
                    help="run the training matrix (run_fl_sharded against "
                         "run_fl_scanned) instead of the selection and "
                         "async matrices")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.devices is not None and args.devices < 1:
        ap.error(f"--devices must be at least 1, got {args.devices}")
    dev = resolve_device(args.device)
    mesh = make_client_mesh(args.devices)
    s = mesh.size()
    print(f"device={dev} mesh_shards={s}")
    if args.train:
        check_training(mesh, dev, max(args.rounds, 4))
        print(f"training parity OK ({s} shards)")
    else:
        check_selection(mesh, dev, args.n, args.rounds)
        check_async(mesh, dev, args.n, args.rounds)
        print(f"parity OK ({s} shards)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
