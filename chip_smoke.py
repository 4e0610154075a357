#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one GPU.

    python3 chip_smoke.py              # needs one CUDA device

Phases (any mismatch exits non-zero; nothing is caught and swallowed):

1. Device: the card's name and power limit; build the Hopper kernels from
   the sources in this checkout and time the build.
2. Each kernel against its plain PyTorch version on the card, on the same
   synthetic inputs: indices equal, values bitwise. The shapes include
   those the later phases give the kernel (N=200, k=10; N=10,000, k=100;
   N=1,048,576, k=100).
3. Selection at fleet scale: 1,048,576 clients, ``eafl``, k=100, three
   rounds of select + simulate_round; the kernel launches once a round,
   and the indices equal the same rounds run on the CPU (plain version).
4. Training parity: ``run_fl`` at the paper model's full width and the
   FLConfig defaults (200 clients, k=10, 10 local steps, B=20), three
   rounds, on the card and on the CPU, TF32 off. The CPU run ranks with
   the affine-folded exploit route, the card with the kernel.
5. Training at scale, the main path: 10,000 clients, k=100, three rounds
   on the card.
6. Timing, on the inputs that phases 5 and 3 gave the kernel.

In phases 3 to 5 every call of the kernel's wrapper is recorded, inputs
and outputs, and its outputs are held against the plain version on the
same inputs. The last two lines of standard output are the kernels' JSON
summary and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOP_PER_S = 67e12             # float32 outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/topk_select.cu"
KERNEL_REPLACES = "src/repro/kernels/topk_select.py:42"
# float32 operations per client of the fused score, by mode, and of ucb
SCORE_FLOPS = {"eafl": 3, "oort": 0, "eafl-epj": 2}
UCB_FLOPS = 2


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ phase 2
def topk_inputs(torch, n, seed, dev, *, ties=False, valid_frac=0.8):
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.rand(n, generator=g)
    b = torch.rand(n, generator=g)
    if ties:
        a[::3] = a[0]
        b[::3] = b[0]
    valid = torch.rand(n, generator=g) < valid_frac
    ucb = torch.rand(n, generator=g) * 0.3
    return [t.to(dev) for t in (a, b, valid, ucb)]


def phase_kernel_vs_plain(torch, ops, ref, dev, sizes):
    cases = []
    for n in sizes:
        for k in (1, 10, 100):
            for mode in ("eafl", "oort", "eafl-epj"):
                for with_ucb in (False, True):
                    cases.append(dict(n=n, k=k, mode=mode, ucb=with_ucb))
        cases.append(dict(n=n, k=min(4096, n), mode="eafl", ucb=True))
        cases.append(dict(n=n, k=100, mode="eafl", ucb=True, ties=True))
        cases.append(dict(n=n, k=100, mode="oort", ucb=False,
                          valid_frac=50.0 / n))
    for i, c in enumerate(cases):
        a, b, valid, ucb = topk_inputs(
            torch, c["n"], i, dev, ties=c.get("ties", False),
            valid_frac=c.get("valid_frac", 0.8))
        if c["mode"] == "eafl-epj":
            b = b * 0.01
        kw = dict(f=0.3, k=c["k"], mode=c["mode"],
                  ucb=ucb if c["ucb"] else None)
        check_same(torch, ops.topk_reward(a, b, valid, **kw),
                   ref.topk_reward(a, b, valid, **kw), c)
    log(f"phase 2: topk_reward kernel == plain on {len(cases)} cases, N in "
        f"{sorted(sizes)} (indices exact, values bitwise)")


def check_same(torch, kernel_out, plain_out, what):
    """Indices equal exactly, values bitwise; returns max |difference|."""
    (kv, ki), (pv, pi) = kernel_out, plain_out
    check(torch.equal(ki, pi), f"kernel indices differ: {what}")
    check(torch.equal(kv.view(torch.int32), pv.view(torch.int32)),
          f"kernel values differ bitwise: {what}")
    fin = torch.isfinite(kv)
    return float((kv[fin] - pv[fin]).abs().max()) if bool(fin.any()) else 0.0


# ------------------------------------------ recording the main path's calls
@contextlib.contextmanager
def recording(ops):
    """Record every call of ``ops.topk_reward`` (copies of its inputs and
    outputs) while the block runs; the launch counter is the wrapper's."""
    calls = []
    wrapper = ops.topk_reward

    def spy(a, b, valid, **kw):
        ins = (a.clone(), b.clone(), valid.clone())
        ucb = kw.get("ucb")
        kw_copy = dict(kw, ucb=None if ucb is None else ucb.clone())
        out = wrapper(a, b, valid, **kw)
        calls.append((ins, kw_copy, tuple(t.clone() for t in out)))
        return out

    ops.topk_reward = spy
    try:
        yield calls
    finally:
        ops.topk_reward = wrapper


def check_recorded(torch, ref, calls, label):
    """Each recorded kernel output against the plain version on the same
    inputs; returns the largest |difference| (0.0 when bitwise equal)."""
    check(calls, f"{label}: the kernel's wrapper was not called")
    err = 0.0
    for j, ((a, b, valid), kw, out) in enumerate(calls):
        err = max(err, check_same(torch, out,
                                  ref.topk_reward(a, b, valid, **kw),
                                  f"{label}, call {j}"))
    return err


# ------------------------------------------------------------------ phase 6
def cuda_ms(torch, fn, args_list, reps=20, trials=5):
    """Milliseconds per call of ``fn``: CUDA events around ``reps``
    back-to-back calls, divided by ``reps``; median of ``trials``. The calls
    rotate over ``args_list`` (copies of the inputs, enough of them to
    exceed the L2 cache where they can)."""
    for args in args_list:
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for r in range(reps):
            fn(*args_list[r % len(args_list)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def copies(tensors, l2_bytes, most=16):
    """Enough clones of ``tensors`` to span twice the L2 cache (at most
    ``most``); returns them and whether they exceed the cache."""
    nbytes = sum(t.nbytes for t in tensors if t is not None)
    count = max(1, min(most, math.ceil(2 * l2_bytes / nbytes)))
    sets = [tuple(None if t is None else t.clone() for t in tensors)
            for _ in range(count)]
    return sets, count * nbytes > l2_bytes


def bound(a, b, valid, ucb, k, mode):
    """Least time for the function: each input byte read once, each output
    written once, at the HBM rate; its float32 operations at the peak rate.
    Returns ``(ms, "bytes" or "operations")``."""
    n = a.shape[0]
    nbytes = sum(t.nbytes for t in (a, b, valid, ucb) if t is not None)
    nbytes += 8 * k
    flops = n * (SCORE_FLOPS[mode] + (UCB_FLOPS if ucb is not None else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def phase_timing(torch, ops, ref, call, label, l2_bytes):
    """Time kernel, plain version and one ``torch.topk`` over the
    materialised score on a recorded call's inputs; also the kernel at
    k=1, whose difference to k bounds the cost of the argmax rounds."""
    (a, b, valid), kw, _ = call
    ucb, k, mode = kw.get("ucb"), kw["k"], kw.get("mode", "eafl")
    extra = {key: v for key, v in kw.items() if key not in ("ucb",)}
    sets, cold = copies((a, b, valid, ucb), l2_bytes)

    def kern(a, b, valid, ucb, **over):
        return ops.topk_reward(a, b, valid, **dict(extra, ucb=ucb, **over))

    def plain(a, b, valid, ucb):
        return ref.topk_reward(a, b, valid, **dict(extra, ucb=ucb))

    scores, _ = copies((ref.reward_score(a, b, valid, f=kw["f"], ucb=ucb,
                                         mode=mode),), l2_bytes)
    first = dict(zip(("a", "b", "valid", "ucb"), sets[0]))
    check_same(torch, kern(**first, k=1),
               ref.topk_reward(**first, **dict(extra, k=1)), f"{label} k=1")
    row = {"n": int(a.shape[0]), "k": int(k), "mode": mode,
           "ucb": ucb is not None, "l2_cold": cold, "copies": len(sets)}
    # in turns, so a drift of the clock reaches all of them alike
    runs = {"ms": [], "plain_ms": [], "library_ms": [], "k1_ms": []}
    for _ in range(2):
        runs["ms"].append(cuda_ms(torch, kern, sets))
        runs["plain_ms"].append(cuda_ms(torch, plain, sets))
        runs["library_ms"].append(
            cuda_ms(torch, lambda s: torch.topk(s, k), scores))
        runs["k1_ms"].append(
            cuda_ms(torch, lambda *s: kern(*s, k=1), sets))
    row.update({key: statistics.median(v) for key, v in runs.items()})
    row["bound_ms"], row["bound_by"] = bound(a, b, valid, ucb, k, mode)
    row["per_round_us"] = (row["ms"] - row["k1_ms"]) / max(k - 1, 1) * 1e3
    log(f"phase 6: topk_reward on {label}'s inputs, N={row['n']} k={k} "
        f"{mode}{'+ucb' if row['ucb'] else ''}, {len(sets)} input copies "
        f"({'beyond' if cold else 'inside'} the L2 cache): kernel "
        f"{row['ms']:.5f} ms (k=1: {row['k1_ms']:.5f} ms, so "
        f"{row['per_round_us']:.3f} us per further argmax round), plain "
        f"{row['plain_ms']:.5f} ms, torch.topk {row['library_ms']:.5f} ms, "
        f"bound {row['bound_ms']:.6f} ms ({row['bound_by']})")
    return row


# ------------------------------------------------------------------ phase 3
def phase_selection(torch, ref, dev, n, rounds):
    from repro_torch import prng
    from repro_torch.core.clients import make_population
    from repro_torch.core.energy import EnergyModel
    from repro_torch.core.selection import (SelectorConfig, SelectorState,
                                            select)
    from repro_torch.federated.simulation import (round_cost_table,
                                                  simulate_round)
    from repro_torch.kernels import ops

    pop = make_population(prng.PRNGKey(0, dev), n)
    g = torch.Generator(device="cpu").manual_seed(3)
    # half the fleet has history, so exploitation ranks 500k clients
    pop = pop.replace(
        explored=(torch.rand(n, generator=g) < 0.5).to(dev),
        stat_util=(torch.rand(n, generator=g) * 50).to(dev),
        last_duration=(torch.rand(n, generator=g) * 400).to(dev))
    em = EnergyModel(busy_fraction=0.02)
    cfg = SelectorConfig("eafl", k=100)

    def run(p, use_kernel):
        key = prng.PRNGKey(11, p.device)
        _, cost = round_cost_table(p, em, 3.0e6, 10, 20)
        state = SelectorState.create(cfg)
        picks = []
        for rnd in range(1, rounds + 1):
            key, ksel = prng.split(key)
            idx, state = select(ksel, cfg, state, p, cost,
                                use_kernel=use_kernel)
            p, out = simulate_round(p, idx, em, 3.0e6, 10, 20, rnd)
            picks.append((idx, out.new_dropouts))
        return picks

    with recording(ops) as calls:
        ops.LAUNCHES["topk_reward"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_dev = run(pop, True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ops.LAUNCHES["topk_reward"]
    check(launches == rounds,
          f"selection launched the kernel {launches} times in {rounds} rounds")
    err = check_recorded(torch, ref, calls, "phase 3")
    on_cpu = run(pop.to("cpu"), True)
    for r, ((i_d, d_d), (i_c, d_c)) in enumerate(zip(on_dev, on_cpu), 1):
        check(np.array_equal(i_d, i_c),
              f"round {r}: card and CPU picks differ")
        check(d_d == d_c, f"round {r}: dropouts differ")
        check(len(i_d) == cfg.k, f"round {r}: {len(i_d)} picks")
    log(f"phase 3: select+simulate_round N={n} eafl k=100 x{rounds} rounds: "
        f"{secs:.3f} s on the card, kernel launches {launches}, each call "
        f"== plain on its inputs, picks equal to the CPU run")
    return launches, err, calls[-1]


# --------------------------------------------------------------- phase 4/5
def fl_config(n_clients, k, rounds):
    from repro_torch.core.selection import SelectorConfig
    from repro_torch.federated.server import FLConfig
    return FLConfig(selector=SelectorConfig("eafl", k=k),
                    n_clients=n_clients, rounds=rounds)


def phase_training_parity(torch, ref, dev, cfg):
    """run_fl on the card against run_fl on the CPU. The two rank the
    exploit slots by different routes (the kernel on the card, the
    affine-folded score on the CPU), so the kernel is held against its
    plain version on the card's own recorded calls instead."""
    from repro_torch.federated.server import run_fl
    from repro_torch.kernels import ops

    with recording(ops) as calls:
        ops.LAUNCHES["topk_reward"] = 0
        on_dev = run_fl(cfg, device=dev)
        launches = ops.LAUNCHES["topk_reward"]
    err = check_recorded(torch, ref, calls, "phase 4")
    on_cpu = run_fl(cfg, device="cpu")
    for f in ("round", "cum_dropouts", "quarantined", "update_skipped"):
        check(getattr(on_dev, f) == getattr(on_cpu, f),
              f"{f}: {getattr(on_dev, f)} != {getattr(on_cpu, f)}")
    # tolerances of tests/test_torch_server.py; test accuracy allows two
    # argmax flips among the eval samples (conv sums in another order)
    for f in ("fairness", "participation", "wall_hours", "mean_battery",
              "energy_spent_j"):
        np.testing.assert_allclose(getattr(on_dev, f), getattr(on_cpu, f),
                                   rtol=1e-5, err_msg=f)
    np.testing.assert_allclose(on_dev.train_loss, on_cpu.train_loss,
                               rtol=2e-3, err_msg="train_loss")
    np.testing.assert_allclose(on_dev.test_acc, on_cpu.test_acc,
                               atol=2.0 / cfg.eval_samples, err_msg="test_acc")
    log(f"phase 4: run_fl full width, {cfg.n_clients} clients, k="
        f"{cfg.selector.k}, {cfg.rounds} rounds: card == cpu (train_loss "
        f"{on_dev.train_loss} vs {on_cpu.train_loss}); kernel launches "
        f"{launches}, each call == plain on its inputs")
    return launches, err


def phase_training_scale(torch, ref, dev, cfg):
    """The main path. One timed run of ``cfg.rounds`` rounds (the launches
    are counted there) after a timed one-round run: their difference over
    ``rounds - 1`` is the steady cost of a round without the set-up."""
    from repro_torch.federated.server import run_fl
    from repro_torch.kernels import ops

    def timed(c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = run_fl(c, device=dev)
        torch.cuda.synchronize()
        return h, time.perf_counter() - t0

    _, one = timed(dataclasses.replace(cfg, rounds=1))
    torch.cuda.reset_peak_memory_stats()
    with recording(ops) as calls:
        ops.LAUNCHES["topk_reward"] = 0
        hist, secs = timed(cfg)
        launches = ops.LAUNCHES["topk_reward"]
    err = check_recorded(torch, ref, calls, "phase 5")
    check(np.isfinite(hist.train_loss).all(), f"loss {hist.train_loss}")
    check(hist.round == list(range(1, cfg.rounds + 1)), f"{hist.round}")
    per_round = (secs - one) / (cfg.rounds - 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 5: run_fl full width, {cfg.n_clients} clients, k="
        f"{cfg.selector.k}, {cfg.rounds} rounds on the card: {secs:.3f} s "
        f"({one:.3f} s for 1 round), so {per_round:.3f} s/round and "
        f"{one - per_round:.3f} s set-up; kernel launches {launches}, each "
        f"call == plain on its inputs; train_loss {hist.train_loss}, "
        f"test_acc {hist.test_acc}, peak memory {peak:.2f} GiB")
    return launches, err, calls[-1]


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi unavailable"
    log(f"phase 1: card {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("phase 1: TF32 off for cuDNN convolutions and matmuls "
        "(parity phases compare float32 with the CPU)")
    t0 = time.perf_counter()
    lib_path = ops.build_library("topk_select")
    ops.load_library("topk_select")
    log(f"phase 1: built {lib_path.name} from {KERNEL_SOURCE} in "
        f"{time.perf_counter() - t0:.2f} s")

    phase_kernel_vs_plain(torch, ops, ref, dev,
                          (200, 4096, 10_000, 1_000_003, 1_048_576))
    sel_launches, sel_err, fleet_call = phase_selection(
        torch, ref, dev, 1_048_576, 3)
    par_launches, par_err = phase_training_parity(
        torch, ref, dev, fl_config(200, 10, 3))
    check(par_launches == 3, f"parity run launched {par_launches}")
    # the main path: counts set to 0 just before it, read just after
    launches, main_err, main_call = phase_training_scale(
        torch, ref, dev, fl_config(10_000, 100, 3))
    check(launches == 3,
          f"run_fl launched the kernel {launches} times in 3 rounds")

    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 50 * 2**20)
    main = phase_timing(torch, ops, ref, main_call, "phase 5", l2)
    fleet = phase_timing(torch, ops, ref, fleet_call, "phase 3", l2)

    summary = {"kernels": [{
        "name": "topk_reward", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "checked": True,
        "launches": launches,
        "max_abs_err": max(sel_err, par_err, main_err),
        "ms": main["ms"], "kernel_ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "shape": {key: main[key] for key in ("n", "k", "mode", "ucb")},
        "timing": main, "fleet_shape": fleet,
        "launches_by_phase": {"selection_1M": sel_launches,
                              "run_fl_parity": par_launches,
                              "run_fl_10k": launches},
    }]}
    log(card)
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
