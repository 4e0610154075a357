"""Federated fine-tuning of an LLM architecture with EAFL selection, on the
CUDA card unless ``--device cpu``.

Bridges the two halves of the system: the EAFL energy-aware selector
(``select``: the top-k reward kernel on the card) decides which simulated
edge clients contribute, ``simulate_round`` drains their batteries, and
the datacenter cohort step (``make_train_step``: on the card the attention
kernel and its backward kernel) trains on their pooled token batches.
Reduced arch, as the reference's example.

  python -m repro_torch.examples.federated_llm_cohort [--arch olmo-1b] \\
      [--rounds 8] [--k 4] [--device cpu]
"""
import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch import prng
from repro_torch.configs import get_reduced
from repro_torch.core import (EnergyModel, SelectorConfig, SelectorState,
                              make_population, select)
from repro_torch.data import lm_batch
from repro_torch.device import resolve_device
from repro_torch.federated import predicted_round_cost_pct, simulate_round
from repro_torch.launch.steps import default_optimizer, make_train_step
from repro_torch.models.transformer import init_params

N_CLIENTS = 64


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Runs the rounds; returns the loss of each round that trained."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    key = prng.PRNGKey(0, dev)
    pop = make_population(key, N_CLIENTS, init_battery_low=20.0)
    sel_cfg = SelectorConfig(kind="eafl", k=args.k, f=0.25)
    sel_state = SelectorState.create(sel_cfg)
    energy = EnergyModel()
    params = init_params(1, cfg, device=dev)
    model_bytes = sum(t.numel() for t in tree_leaves(params)
                      if t is not None) * 4.0

    opt = default_optimizer(lr=5e-3)
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt, device=dev)

    stat = np.zeros((N_CLIENTS,), np.float32)
    losses = []
    for rnd in range(1, args.rounds + 1):
        ksel = prng.fold_in(key, 100 + rnd)
        pred = predicted_round_cost_pct(pop, energy, model_bytes, 4, 8)
        chosen, sel_state = select(ksel, sel_cfg, sel_state, pop, pred)
        pop, outcome = simulate_round(pop, chosen, energy, model_bytes, 4, 8,
                                      rnd)
        ok = chosen[np.asarray(outcome.succeeded)]
        if len(ok) == 0:
            continue
        # each successful client contributes a shard of the cohort batch
        batch = lm_batch(prng.fold_in(key, 200 + rnd), cfg,
                         batch=2 * len(ok), seq_len=64)
        params, opt_state, loss, _ = step(params, opt_state, batch)
        losses.append(float(loss))
        stat[ok] = losses[-1] * pop.n_samples.cpu().numpy()[ok]
        pop = pop.replace(stat_util=torch.as_tensor(stat, device=dev))
        print(f"round {rnd}: clients={ok.tolist()} loss={losses[-1]:.4f} "
              f"mean_battery={float(pop.battery_pct.mean()):.1f}% "
              f"dropped={int(pop.dropped.sum())}", flush=True)
    return losses


if __name__ == "__main__":
    main()
