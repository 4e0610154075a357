"""Training drivers, the reference's ``launch/train.py`` on the port.

  fl      the paper's workload: energy-aware federated training of the
          ResNet speech classifier over the simulated edge population
          (EAFL / Oort / Random), writing ``history.json``;
  cohort  the datacenter cohort step of an LLM architecture: its
          arguments parse, and it raises until LM training is ported
          (ROADMAP.md, queue 1 item 16).

Runs on the CUDA card unless ``--device cpu`` is given:

  python -m repro_torch.launch.train fl --selector eafl --rounds 100 \\
      --out runs/eafl [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

from repro_torch.core.selection import SelectorConfig
from repro_torch.federated import FLConfig, FLHistory, run_fl


def fl_config(args: argparse.Namespace) -> FLConfig:
    """The ``fl`` subcommand's run, from its parsed arguments."""
    sel = SelectorConfig(kind=args.selector, k=args.k, f=args.f)
    return FLConfig(selector=sel, n_clients=args.clients, rounds=args.rounds,
                    local_steps=args.local_steps, batch_size=args.batch_size,
                    server_opt=args.server_opt, seed=args.seed,
                    init_battery_low=args.battery_low,
                    init_battery_high=args.battery_high)


def main_fl(args: argparse.Namespace) -> FLHistory:
    t0 = time.time()
    hist = run_fl(fl_config(args), verbose=True, device=args.device)
    out = args.out or f"runs/fl_{args.selector}"
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "history.json"), "w") as f:
        json.dump(hist.as_dict(), f, indent=1)
    print(f"[fl:{args.selector}] {args.rounds} rounds in "
          f"{time.time() - t0:.1f}s "
          f"acc={hist.test_acc[-1]:.3f} dropouts={hist.cum_dropouts[-1]} "
          f"fairness={hist.fairness[-1]:.3f} -> {out}/history.json")
    return hist


def main_cohort(args: argparse.Namespace) -> None:
    raise NotImplementedError(
        f"train cohort --arch {args.arch}: LM training (loss_fn, "
        f"make_train_step, lm_batch) is not ported yet (ROADMAP.md, queue "
        f"1 item 16)")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    fl = sub.add_parser("fl")
    fl.add_argument("--selector", choices=["eafl", "oort", "random"],
                    default="eafl")
    fl.add_argument("--rounds", type=int, default=100)
    fl.add_argument("--clients", type=int, default=200)
    fl.add_argument("--k", type=int, default=10)
    fl.add_argument("--f", type=float, default=0.25)
    fl.add_argument("--local-steps", type=int, default=10)
    fl.add_argument("--batch-size", type=int, default=20)
    fl.add_argument("--server-opt", default="yogi")
    fl.add_argument("--battery-low", type=float, default=60.0)
    fl.add_argument("--battery-high", type=float, default=100.0)
    fl.add_argument("--seed", type=int, default=0)
    fl.add_argument("--out", default=None)
    fl.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")

    co = sub.add_parser("cohort")
    co.add_argument("--arch", default="olmo-1b")
    co.add_argument("--steps", type=int, default=10)
    co.add_argument("--batch", type=int, default=4)
    co.add_argument("--seq", type=int, default=64)
    co.add_argument("--lr", type=float, default=3e-3)
    co.add_argument("--seed", type=int, default=0)
    co.add_argument("--out", default=None)
    co.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv: Optional[Sequence[str]] = None):
    args = parser().parse_args(argv)
    if args.cmd == "fl":
        return main_fl(args)
    return main_cohort(args)


if __name__ == "__main__":
    main()
