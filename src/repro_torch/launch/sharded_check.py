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
    ``run_rounds_scanned``, index for index on selected/chosen/succeeded.

``--train`` runs the end-to-end training matrix instead:
``run_fl_sharded`` against ``run_fl_scanned`` (four configurations,
overcommit and recharge among them), exact on the selection, dropout and
duration bookkeeping and within 5e-4 on the float model statistics (the
sharded aggregate sums per-shard partial products, a reordered float32
reduction; on a card both engines run cuDNN's deterministic float32
algorithms for it); it prints ``training parity OK``.

Exits non-zero at the first mismatch; prints ``parity OK`` when the whole
matrix passes. The reference's async matrix (``run_async_sharded``) is
not ported yet (ROADMAP.md, queue 1 item 13).

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
from repro_torch.device import resolve_device
from repro_torch.federated.simulation import (run_rounds_scanned,
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


def check_training(mesh, dev, rounds: int = 4) -> None:
    """End-to-end training parity: ``run_fl_sharded`` against
    ``run_fl_scanned`` (itself held against the host loop). The selection,
    dropout and duration bookkeeping must be exact; the float model
    statistics within 5e-4. On a card both run float32 convolutions with
    cuDNN's deterministic algorithms (TF32 off), so that the only
    difference left is the sharded aggregate's reduction order: cuDNN's
    default algorithms differ from run to run by more than that, and
    training amplifies it."""
    if dev.type == "cuda":
        flags = (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return _check_training(mesh, dev, rounds)
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
    return _check_training(mesh, dev, rounds)


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
        "The synchronous parity matrix of the sharded engines (selection, "
        "or training with --train) on a clients mesh of --devices virtual "
        "shards. The reference's async legs (run_async_sharded) are not "
        "ported yet (ROADMAP.md, queue 1 item 13)."))
    ap.add_argument("--devices", type=int, default=None,
                    help="virtual shards of the clients mesh (default 1)")
    ap.add_argument("--n", type=int, default=999,
                    help="population size of the main matrix (default not "
                         "divisible by 2 or 8)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--train", action="store_true",
                    help="run the training matrix (run_fl_sharded against "
                         "run_fl_scanned) instead of the selection matrix; "
                         "the async matrix is not ported yet (ROADMAP.md, "
                         "queue 1 item 13)")
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
        print(f"parity OK ({s} shards)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
