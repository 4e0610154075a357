"""Buffered-asynchronous FL (FedBuff-style) against the synchronous barrier.

Two demonstrations on the paper's battery-powered task, on the CUDA card
unless ``--device cpu``:

  1. PARITY: with ``buffer_size == max_concurrency == k`` and staleness
     damping off, the event-stepped async engine reproduces the sync
     engine's selection and round durations, both forced through the
     ``run_rounds`` front door (``mode="scanned"`` / ``"async-scanned"``).
  2. ASYNC WINS: with a small buffer and extra concurrency the server
     aggregates as soon as ``buffer_size`` updates arrive instead of
     waiting for the slowest client, so wall-clock per update drops. The
     async leg goes through ``run_fl``, which resolves the fused FedBuff
     engine (``run_fl_async_scanned``).

  python -m repro_torch.examples.async_fedbuff [--aggregations 20] \\
      [--device cpu]
"""
import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch import prng
from repro_torch.configs.paper_resnet_speech import reduced
from repro_torch.core.clients import make_population
from repro_torch.core.energy import EnergyModel
from repro_torch.core.selection import SelectorConfig, SelectorState
from repro_torch.device import resolve_device
from repro_torch.federated import FLConfig, run_fl, run_rounds


def parity_demo(rounds: int = 10, n: int = 200, k: int = 10, device=None):
    """Both engines through ``run_rounds``, one forced engine a leg."""
    dev = resolve_device(device)
    key = prng.PRNGKey(0, dev)
    cfg = SelectorConfig(kind="eafl", k=k)
    em = EnergyModel()
    pop = make_population(prng.fold_in(key, 1), n,
                          init_battery_low=15.0, init_battery_high=90.0)
    pop = pop.replace(stat_util=prng.uniform(prng.fold_in(key, 2),
                                             (n,)) * 10)
    krun = prng.fold_in(key, 3)
    _, _, sync = run_rounds(krun, cfg, pop, SelectorState.create(cfg),
                            em, 85e6, 400, 20, rounds, mode="scanned")
    _, _, asyn = run_rounds(krun, cfg, pop, SelectorState.create(cfg),
                            em, 85e6, 400, 20, rounds, mode="async-scanned",
                            buffer_size=k, max_concurrency=k,
                            staleness_power=0.0)
    same_sel = np.array_equal(sync["selected"], asyn["selected"])
    same_dur = np.allclose(sync["round_duration"], asyn["round_duration"],
                           rtol=1e-6)
    print(f"[parity] {sync['engine']} vs {asyn['engine']} "
          f"(buffer=concurrency=k, damping off) -> "
          f"selection identical: {same_sel}, durations match: {same_dur}")
    assert same_sel and same_dur
    return sync, asyn


def fl_config(kind: str, aggregations: int, **kw) -> FLConfig:
    base = dict(
        selector=SelectorConfig(kind=kind, k=8),
        n_clients=60, rounds=aggregations, local_steps=6, batch_size=10,
        samples_per_client=48, eval_every=5, eval_samples=280,
        model=reduced(), input_hw=16,
        sim_model_bytes=85e6, sim_local_steps=1600,
        init_battery_low=8.0, init_battery_high=60.0)
    base.update(kw)
    return FLConfig(**base)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--aggregations", type=int, default=20,
                    help="server updates for each leg")
    ap.add_argument("--kind", default="eafl",
                    choices=["eafl", "oort", "random"])
    ap.add_argument("--buffer-size", type=int, default=3)
    ap.add_argument("--max-concurrency", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    parity_demo(device=args.device)

    # mode="auto": no async knobs -> the synchronous barrier; buffer_size
    # / max_concurrency set -> FedBuff on the fused engine
    h_sync = run_fl(fl_config(args.kind, args.aggregations),
                    device=args.device)
    h_async = run_fl(fl_config(args.kind, args.aggregations,
                               buffer_size=args.buffer_size,
                               max_concurrency=args.max_concurrency),
                     device=args.device)
    for name, h in (("sync", h_sync), ("async", h_async)):
        print(f"[{name:5s}] {args.aggregations} server updates in "
              f"{h.wall_hours[-1]:.2f}h wall "
              f"(mean {3600*h.wall_hours[-1]/len(h.round):.0f}s/update)  "
              f"acc={h.test_acc[-1]:.3f} dropouts={h.cum_dropouts[-1]} "
              f"fairness={h.fairness[-1]:.3f}")
    speed = h_sync.wall_hours[-1] / max(h_async.wall_hours[-1], 1e-9)
    print(f"[async] buffer={args.buffer_size} "
          f"concurrency={args.max_concurrency}: {speed:.2f}x faster "
          f"wall-clock per server update than the synchronous barrier")
    return h_sync, h_async


if __name__ == "__main__":
    main()
