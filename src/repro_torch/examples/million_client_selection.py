"""EAFL selection at production scale: the selection engine against a
population of one million clients, on the CUDA card unless
``--device cpu``.

Four things are shown and cross-checked:
  1. the top-k reward kernel (``kernels/csrc/topk_select.cu`` on the
     card, its plain version on the CPU) against the plain version:
     indices equal, values bitwise;
  2. one selection step (``select``: scores, exploration ranks, state
     update; the kernel on the card) against the eager host oracle
     ``select_host``: the picks equal, index for index;
  3. a multi-round run of the fused selection, energy and battery engine
     (``run_rounds_scanned``, replayed from a CUDA graph on the card) over
     the same population;
  4. the sharded engine (``run_rounds_sharded``: the population split
     over a ``clients`` mesh of ``--devices D`` virtual shards, each
     shard's exploit leg the kernel with its own ``index_offset``)
     against the single-device run, index for index.

  python -m repro_torch.examples.million_client_selection [--n 65536] \\
      [--devices 8] [--device cpu]
"""
import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.clients import make_population
from repro_torch.core.energy import EnergyModel
from repro_torch.core.selection import (SelectorConfig, SelectorState,
                                        select, select_host)
from repro_torch.device import resolve_device
from repro_torch.federated import run_rounds_scanned, run_rounds_sharded
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_client_mesh


def _clock(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_048_576,
                    help="population size (e.g. 65536 for a quick run)")
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--devices", type=int, default=None,
                    help="virtual shards of step 4's clients mesh "
                         "(default 1)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.devices is not None and args.devices < 1:
        ap.error(f"--devices must be at least 1, got {args.devices}")
    dev = resolve_device(args.device)
    N, K, F = args.n, min(args.k, args.n), 0.25
    key = prng.PRNGKey(0, dev)
    times = {}

    # --- 1. the kernel against its plain version ---------------------
    util = prng.uniform(key, (N,))
    power = prng.uniform(prng.fold_in(key, 1), (N,))
    valid = prng.bernoulli(prng.fold_in(key, 2), 0.97, (N,))
    t0 = _clock(dev)
    ev, ei = ref.topk_reward(util, power, valid, f=F, k=K)
    times["plain_s"] = _clock(dev) - t0
    ops.topk_reward(util, power, valid, f=F, k=K)      # build + warm up
    t0 = _clock(dev)
    tv, ti = ops.topk_reward(util, power, valid, f=F, k=K)
    times["kernel_s"] = _clock(dev) - t0
    assert torch.equal(ti, ei), "kernel indices != plain"
    assert torch.equal(tv, ev), "kernel values != plain"
    print(f"[kernel] selected {K} of {N:,} clients on {dev}")
    print(f"[kernel] plain   : {times['plain_s']*1e3:8.3f} ms")
    route = ("the Hopper kernel" if dev.type == "cuda"
             else "the plain version on the CPU")
    print(f"[kernel] kernel  : {times['kernel_s']*1e3:8.3f} ms ({route})")

    # --- 2. one selection step against the host oracle ----------------
    pop = make_population(prng.fold_in(key, 3), N)
    ks = prng.split(prng.fold_in(key, 4), 2)
    pop = pop.replace(stat_util=prng.uniform(ks[0], (N,)) * 10,
                      explored=prng.bernoulli(ks[1], 0.7, (N,)))
    cfg = SelectorConfig(kind="eafl", k=K)
    state = SelectorState.create(cfg)
    pred = torch.abs(prng.normal(prng.fold_in(key, 5), (N,))) * 5

    ksel = prng.fold_in(key, 6)
    select(ksel, cfg, state, pop, pred)           # build + warm up
    select_host(ksel, cfg, state, pop, pred)
    t0 = _clock(dev)
    idx_dev, _ = select(ksel, cfg, state, pop, pred)
    times["select_s"] = _clock(dev) - t0
    t0 = _clock(dev)
    idx_host, _ = select_host(ksel, cfg, state, pop, pred)
    times["select_host_s"] = _clock(dev) - t0
    assert np.array_equal(idx_dev, idx_host), "select != select_host"
    print(f"[select] host    : {times['select_host_s']*1e3:8.3f} ms")
    print(f"[select] select  : {times['select_s']*1e3:8.3f} ms "
          f"({times['select_host_s']/max(times['select_s'], 1e-9):.1f}x)")

    # --- 3. multi-round fused engine ----------------------------------
    em = EnergyModel()
    t0 = _clock(dev)
    fpop, _, traj = run_rounds_scanned(
        prng.fold_in(key, 7), cfg, pop, SelectorState.create(cfg),
        em, 85e6, 400, 20, rounds=args.rounds)
    times["scan_s"] = _clock(dev) - t0
    drop = int(traj["total_dropped"][-1])
    print(f"[scan]   {args.rounds} rounds over {N:,} clients in "
          f"{times['scan_s']*1e3:.1f} ms (with warm-up and capture); "
          f"final mean battery {float(fpop.battery_pct.mean()):.1f}%, "
          f"{drop:,} dropped")

    # --- 4. the sharded engine against the single-device run ----------
    mesh = make_client_mesh(args.devices)
    t0 = _clock(dev)
    _, _, straj = run_rounds_sharded(
        prng.fold_in(key, 7), cfg, pop, SelectorState.create(cfg),
        em, 85e6, 400, 20, rounds=args.rounds, mesh=mesh)
    times["shard_s"] = _clock(dev) - t0
    assert np.array_equal(traj["selected"], straj["selected"]), \
        "sharded selection trajectory != single-device"
    assert np.array_equal(traj["chosen"], straj["chosen"])
    print(f"[shard]  same {args.rounds} rounds on a {mesh.size()}-shard "
          f"clients mesh in {times['shard_s']*1e3:.1f} ms (with warm-up "
          f"and capture); selection trajectory identical index for index")
    return times


if __name__ == "__main__":
    main()
