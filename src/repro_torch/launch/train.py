"""Training drivers, the reference's ``launch/train.py`` on the port.

  fl      the paper's workload: energy-aware federated training of the
          ResNet speech classifier over the simulated edge population
          (EAFL / Oort / Random), writing ``history.json``;
  cohort  the datacenter cohort step of an LLM architecture, at its
          reduced config (as the reference): ``make_train_step``'s AdamW
          steps on ``lm_batch`` token streams, on one device; the loss
          must decrease; ``--out`` writes ``cohort.msgpack``. All ten
          archs train; internvl2-2b's batches carry its patch
          embeddings, musicgen-large's its codebook streams.

Runs on the CUDA card unless ``--device cpu`` is given:

  python -m repro_torch.launch.train fl --selector eafl --rounds 100 \\
      --out runs/eafl [--device cpu]
  python -m repro_torch.launch.train cohort --arch olmo-1b --steps 10 \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Sequence

from repro_torch import prng
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_reduced
from repro_torch.core.selection import SelectorConfig
from repro_torch.data import lm_batch
from repro_torch.device import resolve_device
from repro_torch.federated import FLConfig, FLHistory, run_fl
from repro_torch.launch.steps import default_optimizer, make_train_step
from repro_torch.models.transformer import init_params


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


def main_cohort(args: argparse.Namespace) -> List[float]:
    """``--steps`` AdamW steps of the reduced ``--arch`` on batch ``i``'s
    ``lm_batch(fold_in(PRNGKey(seed), i))``; returns the losses. Raises if
    the mean of the last three losses is not below the first (the
    reference's assertion)."""
    cfg = get_reduced(args.arch)
    dev = resolve_device(args.device)
    opt = default_optimizer(lr=args.lr)
    key = prng.PRNGKey(args.seed, dev)
    params = init_params(args.seed, cfg, device=dev)
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt, device=dev)
    losses = []
    for i in range(args.steps):
        batch = lm_batch(prng.fold_in(key, i), cfg, args.batch, args.seq)
        params, opt_state, loss, metrics = step(params, opt_state, batch)
        losses.append(float(loss))
        print(f"step {i}: loss={losses[-1]:.4f} "
              f"ce={float(metrics['ce']):.4f}", flush=True)
    tail = losses[-3:] if len(losses) >= 3 else losses[-1:]
    if not sum(tail) / len(tail) < losses[0]:
        raise AssertionError(f"loss must decrease over the cohort steps: "
                             f"{losses}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        save_checkpoint(os.path.join(args.out, "cohort.msgpack"), params,
                        step=args.steps)
    print(f"[cohort:{args.arch}] loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


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
