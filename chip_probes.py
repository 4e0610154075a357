#!/usr/bin/env python3
"""Design probes of the two bf16 scan kernels and both scan backwards,
and their times and the attention backward's beside another checkout's
kernels, on one GPU.

    python3 chip_probes.py [--seed N] [--parent DIR] [--only PART]

A developer's tool: it decides nothing, and neither ``chip_smoke.py`` nor
``chip_faults.py`` runs it. Each probe is one edit of a sound kernel
source under ``src/repro_torch/kernels/csrc/``, built with the library's
own flags into a temporary directory, as ``chip_faults.py`` builds its
faults (the checkout is left as it is):

- ``SSD_PROBES``: each split operand of ``ssd_fwd_mma`` (att, the carried
  state h, w x) with its low part dropped, and hd cut into 1 or 4 column
  slices for 2;
- ``SCAN_PROBES``: ``scan_fwd``'s decay argument without its low part, 2
  or 8 lanes a channel for 4, 256 or 512 threads a CTA for 128, and its
  f32 route with the cheap decay, with and without the argument's low
  part;
- ``SSD_BWD_PROBES``: the bf16 SSD backward (``ssd_bwd_carry`` and
  ``ssd_bwd_local``) with 8, 16 or 32 heads a chunk-local CTA for 64,
  and each split operand (the carry's e^l dy, K, h0, Dm, E, E dt)
  without its low part;
- ``SCAN_BWD_PROBES``: the selective-scan backward (``scan_bwd_cluster``)
  with the bf16 route on ``expf``, its decay argument without its low
  part, clusters of 1 or 4 CTAs for 2, 128-thread CTAs (32 channels) for
  256, the tile before's loads waited for at each sub-tile, and, timing
  only (each fails), parts taken out: the dB/dC channel sums'
  shuffles, the first pass, the walk back.

For the sound kernel and each probe it prints the tight check of
``chip_faults.py`` (phase 8's and 12's bf16 cases at the prefill shape,
fast and slow decay, and the first call of a full-width prefill), the
milliseconds a call on that prefill call's inputs (as ``chip_smoke.py``
phases 11 and 16 time the kernels, in turns) and, for the selective scan,
the f32 route's largest error on the prefill shape with slow decay
against ``SCAN_TOL``'s f32 tolerance. A probe whose text no longer occurs
once in its source stops the script.

``--parent DIR`` also builds the SSD and scan sources and the three
backward sources of another checkout (say the parent commit's, unpacked by ``git
archive``) with this checkout's flags, launches them through that
checkout's own launchers, times them in the same turns (first in the
first turn, last in the second) and reads the SASS loop counts of both
checkouts' kernels as ``chip_smoke.py``'s phase 1 does.

The attention backward is timed at the olmo-1b train step's shape (4,
4096, 16 heads of 128, bf16, causal; o and the log-sum-exp from the
forward kernel) as phase 20 times it, this checkout's kernel beside the
parent's in turns, with both kernels' tight readings (relative L2 from
the f32 backward of the same inputs), dk and dv against each other and
the static SASS counts of each backward entry (wgmma, TMA, ``mma.sync``,
atomics). The SSD backward (``SSD_BWD_CASES``) is read the same way: the
sound kernel, each of ``SSD_BWD_PROBES`` and the parent's, each one's
tight readings on zamba2-1.2b's train-step shape (4, 4096, 64 heads of
64, ds 64, bf16; the states from this checkout's forward kernel) and two
of phase 21's slow-decay cases and whether they hold phase 21's limits,
then all timed at the step's shape in four turns. The selective-scan
backward (``SCAN_BWD_CASES``) likewise: the sound kernel, each of
``SCAN_BWD_PROBES`` and the parent's, their tight readings on
falcon-mamba-7b's train-step shape (4, 4096, 8192, ds 16, bf16) and two
of phase 23's cases (4,096 slowly decaying steps; a ragged last tile at
ds 8), whether they hold phase 23's limits, and their times at the step
shape in four turns. The attention backward's own design at (192, 128),
``flash_bwd_wgmma_wide``, is read at deepseek-v2-236b's train-step shape
(4, 4096, 128 heads, 192 / 128, bf16, causal): the sound kernel and each
of ``WIDE_BWD_PROBES`` (the grid with heads as its fast axis, S^T and dP^T
aliased with dQ's accumulators, and, timing only, dQ's reduce-adds taken
out), their tight readings and their times in four turns, beside SDPA's
backward. ``--only scans``, ``--only attention_bwd``, ``--only
ssd_bwd``, ``--only scan_bwd`` or ``--only attention_bwd_wide`` runs one
part.

The last line is one JSON object with all the readings; without a CUDA
device it exits 2.

``--engines DIR`` probes no kernel: it times each replayed step of the
fused engines (``run_fl_scanned`` and ``run_fl_async_scanned`` at phases
6c's and 6g's settings: 10,000 clients, k = 100, full width, buffer 25
and concurrency 100 for the async one, cuDNN's default algorithms, TF32
off) of DIR's package and of this checkout's, in turns (DIR, this, this,
DIR), each in a process of its own, two runs of 3 replays each, with
``chip_smoke.py``'s ``replay_timing``. ``--train-steps DIR`` in the same
way runs a scan arch's train step as phase 22 (``--arch zamba2-1.2b``,
the default) or 24 (``--arch falcon-mamba-7b``, 16 layers) does (3 steps
at 4 x 4096, a fourth profiled, the routes) for DIR's package and this
one in turns, a process each, and prints each run's step times,
tokens/s, peak memory and the profiled step's device time by layer
(about 4 minutes).
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_faults as cf
import chip_smoke as cs

# name: (text in the kernel source, its replacement); each text occurs once
SSD_PROBES = {
    "att_low_part_dropped": (
        "          mma(yacc[2 * np], alo, xf[0], xf[1]);\n"
        "          mma(yacc[2 * np + 1], alo, xf[2], xf[3]);\n", ""),
    "h_low_part_dropped": cf.SSD_FAULTS["h_low_part_dropped"],
    "wx_low_part_dropped": cf.SSD_FAULTS["wx_low_part_dropped"],
    "slices_1": ("constexpr int kSlices = 2;", "constexpr int kSlices = 1;"),
    "slices_4": ("constexpr int kSlices = 2;", "constexpr int kSlices = 4;"),
}
SCAN_PROBES = {
    "decay_low_part_dropped": (
        "da = ex2(fmaf(v.x, a2hi[j], v.x * a2lo[j]));",
        "da = ex2(v.x * a2hi[j]);"),
    "lanes_2": ("constexpr int kLanes = 4;", "constexpr int kLanes = 2;"),
    "lanes_8": ("constexpr int kLanes = 4;", "constexpr int kLanes = 8;"),
    "threads_256": ("constexpr int kThreads = 128;",
                    "constexpr int kThreads = 256;"),
    "threads_512": ("constexpr int kThreads = 128;",
                    "constexpr int kThreads = 512;"),
    "f32_cheap_decay": (
        "struct CheapDecay<float> {\n  static constexpr bool value = false;",
        "struct CheapDecay<float> {\n  static constexpr bool value = true;"),
    # both routes: ex2.approx of dt (A log2 e) rounded to one float
    "f32_cheap_decay_no_low_part": (
        "          if constexpr (kCheap)\n"
        "            da = ex2(fmaf(v.x, a2hi[j], v.x * a2lo[j]));",
        "          if constexpr (true)\n"
        "            da = ex2(v.x * a2hi[j]);"),
}
PROBES = {"ssd_chunk": SSD_PROBES, "selective_scan": SCAN_PROBES}


def _lines(*lines):
    """Lines of a kernel source, to drop: ``(text, "")``."""
    return ("".join(f"{line}\n" for line in lines), "")


# edits of the SSD backward's bf16 kernels: G, the heads a chunk-local CTA
# walks (64 holds every head of zamba2-1.2b: dB and dC by plain stores);
# each split operand without its low part
SSD_BWD_PROBES = {
    "heads_8": ("constexpr int kHeadGroup = 64;",
                "constexpr int kHeadGroup = 8;"),
    "heads_16": ("constexpr int kHeadGroup = 64;",
                 "constexpr int kHeadGroup = 16;"),
    "heads_32": ("constexpr int kHeadGroup = 64;",
                 "constexpr int kHeadGroup = 32;"),
    "carry_el_dy_low_part_dropped": _lines(
        "        mma(acc[2 * np], ca, lo[0], lo[1]);",
        "        mma(acc[2 * np + 1], ca, lo[2], lo[3]);"),
    "k_low_part_dropped": ([_lines(
        "        mma(z[2 * np], ba, kl[0], kl[1]);",
        "        mma(z[2 * np + 1], ba, kl[2], kl[3]);"), _lines(
        "        mma(db[2 * nn], xa[kp], kl[0], kl[1]);",
        "        mma(db[2 * nn + 1], xa[kp], kl[2], kl[3]);")], None),
    "h0_low_part_dropped": _lines(
        "          mma(dc[2 * nn], ya, hl[0], hl[1]);",
        "          mma(dc[2 * nn + 1], ya, hl[2], hl[3]);"),
    "dm_low_part_dropped": cf.SCAN_BWD_FAULTS[
        "ssd_local_dm_low_part_dropped"][1][0],
    "e_low_part_dropped": _lines(
        "        mma(db[2 * nn], el, f[0], f[1]);",
        "        mma(db[2 * nn + 1], el, f[2], f[3]);"),
    "e_dt_low_part_dropped": _lines(
        "        mma(dc[2 * nn], al, f[0], f[1]);",
        "        mma(dc[2 * nn + 1], al, f[2], f[3]);"),
}
# the first SSD kernel's bf16 entry (one CTA of full hd a (batch, head),
# scalar FMAs), counted where a checkout has no tensor-core kernel
FIRST_SSD_ENTRY = "ssd_fwdI13__nv_bfloat16Li64ELi64E"
# the first selective-scan backward design's bf16 entry at ds 16
# (scan_bwd), counted where a checkout has not this design
FIRST_SCAN_BWD_ENTRY = "scan_bwdI13__nv_bfloat16Li16E"
# library: (its launcher module, binder, launch function) in a checkout
LAUNCHERS = {"ssd_chunk": ("ssd_chunk", "bind", "launch"),
             "selective_scan": ("selective_scan", "bind", "launch"),
             "flash_attention_bwd": ("flash_attention", "bind_bwd",
                                     "launch_bwd"),
             "ssd_chunk_bwd": ("ssd_chunk", "bind_bwd", "launch_bwd"),
             "selective_scan_bwd": ("selective_scan", "bind_bwd",
                                    "launch_bwd")}
# edits of the selective-scan backward: the bf16 route on expf, its decay
# argument without the low part; clusters of 1 or 4 CTAs for 2; 128-thread
# CTAs of 32 channels; the loads of the tile before waited for at each
# sub-tile; and, for timing only (the gradients are then wrong), parts
# taken out: the dB/dC channel sums' shuffles, the first pass, the walk
# back
SCAN_BWD_PROBES = {
    "bf16_expf": (
        "struct CheapDecay {\n  static constexpr bool value = true;",
        "struct CheapDecay {\n  static constexpr bool value = false;"),
    "decay_low_part_dropped": (
        "      return ex2(fmaf(dtv, hi[j], dtv * lo[j]));",
        "      return ex2(dtv * hi[j]);"),
    "sums_unshuffled": (
        "        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, half * "
        "kLanes);", "        v[i] = keep + send;"),
    "cluster_1": ("constexpr int kCluster = 2;", "constexpr int kCluster = 1;"),
    "cluster_4": ("constexpr int kCluster = 2;", "constexpr int kCluster = 4;"),
    "threads_128": ("constexpr int kThreads = 256;",
                    "constexpr int kThreads = 128;"),
    "loads_waited": (
        "             t0 + s * kSub);\n",
        "             t0 + s * kSub);\n      cp_async_wait();\n"),
    "first_pass_taken_out": (
        "    for (int sub = 0; sub + 1 < kNSub; ++sub) {",
        "    for (int sub = 0; sub + 1 < 0; ++sub) {"),
    "walk_back_taken_out": (
        "      for (int grp = kSub / 4 - 1; grp >= 0; --grp) {",
        "      for (int grp = kSub / 4 - 1; grp >= kSub; --grp) {"),
}
# probes of the attention backward's own design at (192, 128),
# flash_bwd_wgmma_wide: the grid with heads as its fast axis (as
# flash_bwd_wgmma's), S^T and dP^T in one array with dQ's accumulators (as
# flash_bwd_wgmma's), and, for timing only (dq is then wrong), dQ's
# reduce-adds taken out
WIDE_BWD_PROBES = {
    "heads_fast_axis": ([
        ("  const int b = blockIdx.y / KH, kh = blockIdx.y % KH, G = H / KH;\n"
         "  const int k0 = blockIdx.x * T::kBK;",
         "  const int b = blockIdx.x / KH, kh = blockIdx.x % KH, G = H / KH;\n"
         "  const int k0 = blockIdx.y * T::kBK;"),
        ("kWide<DQK, DV> ? dim3(tiles, B * KH) : dim3(B * KH, tiles)",
         "dim3(B * KH, tiles)")], None),
    "accumulators_aliased": ([
        ("      float s[16], dp[16];",
         "      float acc[64];\n"
         "      float(&s)[16] = *reinterpret_cast<float(*)[16]>(acc);\n"
         "      float(&dp)[16] = *reinterpret_cast<float(*)[16]>(acc + 16);"),
        ("      float dq0[32], dq1[32];",
         "      float(&dq0)[32] = *reinterpret_cast<float(*)[32]>(acc);\n"
         "      float(&dq1)[32] = "
         "*reinterpret_cast<float(*)[32]>(acc + 32);")], None),
    "dq_reduce_taken_out": (
        "      if (tid == 0) {\n        tma_reduce_add(&dqmap, qb, 64 * wg,",
        "      if (false) {\n        tma_reduce_add(&dqmap, qb, 64 * wg,"),
}
# B, S, H, KH, Dqk, Dv of the wide probes: deepseek-v2-236b's train step
WIDE_BWD_SHAPE = (4, 4096, 128, 128, 192, 128)
# the libraries each part of the probes builds from a parent checkout (the
# wide part none: a parent's backward may not take (192, 128))
PARTS = {"scans": ("ssd_chunk", "selective_scan"),
         "attention_bwd": ("flash_attention_bwd",),
         "ssd_bwd": ("ssd_chunk_bwd",),
         "scan_bwd": ("selective_scan_bwd",),
         "attention_bwd_wide": ()}
# the bf16 backward entries at hd 128, of this design and of the mma.sync
# one before it
BWD_ENTRIES = ("flash_bwd_wgmmaILi128E", "flash_bwd_mmaILi128E")


def build_probes(ops, tmp):
    """The sound SSD and scan libraries and every probe, one nvcc each, all
    at once; returns ``{lib: {"sound" or probe name: bound library}}``."""
    with ThreadPoolExecutor(sum(len(p) + 1 for p in PROBES.values())) as pool:
        sound = {lib: pool.submit(ops.build_library, lib) for lib in PROBES}
        built = {lib: {n: pool.submit(cf.build_fault, ops, lib, n, o, w, tmp)
                       for n, (o, w) in probes.items()}
                 for lib, probes in PROBES.items()}
        libs = {}
        for lib in PROBES:
            sound[lib].result()
            libs[lib] = {"sound": ops.load_library(lib)}
            libs[lib].update({n: ops._BINDERS[lib](ctypes.CDLL(str(
                f.result()))) for n, f in built[lib].items()})
    return libs


def build_bwd_probes(ops, lib, probes, tmp):
    """The sound backward library ``lib`` and each of its ``probes``, one
    nvcc each, all at once: ``{"sound" or probe name: bound library}``."""
    with ThreadPoolExecutor(len(probes) + 1) as pool:
        sound = pool.submit(ops.build_library, lib)
        built = {n: pool.submit(cf.build_fault, ops, lib, n, o, w, tmp)
                 for n, (o, w) in probes.items()}
        sound.result()
        libs = {"sound": ops.load_library(lib)}
        libs.update({n: ops._BINDERS[lib](ctypes.CDLL(str(f.result())))
                     for n, f in built.items()})
    return libs


def load_parent(ops, root, out_dir, names=tuple(LAUNCHERS)):
    """The kernels of another checkout ``root``: each library built from
    ``root``'s source with this checkout's flags into ``out_dir``, one nvcc
    each, and launched by ``root``'s own launcher module (``LAUNCHERS``).
    Returns ``({name: fn(*args, **kw)}, {name: library path})``; logs
    each build's seconds."""
    kdir = Path(root).resolve() / "src" / "repro_torch" / "kernels"

    def build(name):
        so = Path(out_dir) / f"libparent_{name}.so"
        t0 = time.perf_counter()
        proc = subprocess.run([ops._nvcc(), *ops.nvcc_flags(name), "-o",
                               str(so), str(kdir / "csrc" / f"{name}.cu")],
                              capture_output=True, text=True)
        cs.check(proc.returncode == 0, f"nvcc failed for {root}'s {name}:\n"
                 f"{proc.stderr[-2000:]}")
        return so, time.perf_counter() - t0

    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build, names)))
    cs.log(f"{root}'s libraries built with nvcc, s each (in parallel): "
           f"{ {n: round(t, 2) for n, (_, t) in built.items()} }")
    sos = {n: so for n, (so, _) in built.items()}
    fns = {}
    for name in names:
        module, binder, launcher = LAUNCHERS[name]
        spec = importlib.util.spec_from_file_location(f"parent_{module}",
                                                      kdir / f"{module}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        lib = getattr(mod, binder)(ctypes.CDLL(str(sos[name])))
        fns[name] = (lambda f, lb: lambda *a, **kw: f(lb, *a, **kw))(
            getattr(mod, launcher), lib)
    return fns, sos


def times(torch, fns, args, l2_bytes):
    """Milliseconds a call of each function in ``fns`` (``{name: fn}``) on
    ``args``, as chip_smoke.py times the kernels (L2-cold copies, 20
    back-to-back calls, median of 5 trials), in two turns, forward then
    backward; the median of the two."""
    sets, _ = cs.copies(args, l2_bytes)
    runs = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            runs[name].append(cs.cuda_ms(torch, fns[name], sets))
    return {name: statistics.median(ms) for name, ms in runs.items()}


def bwd_sass(ops, paths):
    """Static ``chip_smoke.BWD_SASS_OPS`` counts of each bf16 hd-128
    backward entry in the libraries at ``paths`` (``{checkout: path}``)."""
    tool = Path(ops._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return "no cuobjdump"
    out = {}
    for who, path in paths.items():
        sass = subprocess.run([str(tool), "-sass", str(path)],
                              capture_output=True, text=True).stdout
        for entry in BWD_ENTRIES:
            if entry in sass:
                counts = next(iter(cs.sass_ops(sass, entry).values()))
                out[who] = {"entry": entry, **{
                    op: counts.get(op, 0) for op in cs.BWD_SASS_OPS}}
    return out


def attention_bwd_turns(torch, ops, ref, parent, l2_bytes):
    """The backward at the olmo-1b step's shape, this checkout's kernel and
    (``parent``: a launch function, or None) the parent's, timed in turns;
    each one's tight readings, and dk, dv of the two against each other
    (dq's additions arrive in no fixed order)."""
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    B, S, H, KH, D = next(c for c in cs.BWD_SHAPES if c[:2] == (4, 4096))
    q, k, v, do = cs.attn_bwd_inputs(torch, B, S, H, KH, D, torch.bfloat16,
                                     dev, 300 + cs.BWD_SHAPES.index(
                                         (B, S, H, KH, D)))
    o, lse = fa.launch(ops.load_library("flash_attention"), q, k, v,
                       causal=True, with_lse=True)
    lib = ops.load_library("flash_attention_bwd")
    fns = {"this": lambda *a: fa.launch_bwd(lib, *a, causal=True)}
    if parent is not None:
        fns = {"parent": lambda *a: parent(*a, causal=True), **fns}
    args = (q, k, v, o, lse, do)
    out = {"shape": [B, S, H, KH, D], "card": cs.card_name_power(),
           "tight": {}, "bound_ms": cs.bwd_bound(q, k, v, True)}
    grads = {}
    for name, fn in fns.items():
        grads[name] = fn(*args)
        out["tight"][name] = cs.bwd_rel_l2(torch, ref, grads[name], *args,
                                           True)
    if parent is not None:
        out["this_vs_parent_max_abs"] = {
            g: float((grads["this"][i].float()
                      - grads["parent"][i].float()).abs().max())
            for i, g in enumerate(("dq", "dk", "dv"))}
    del grads
    torch.cuda.synchronize()
    sets, _ = cs.copies(args, l2_bytes)
    runs = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1], list(fns), list(fns)[::-1]):
        for name in order:
            runs[name].append(cs.cuda_ms(torch, fns[name], sets, reps=5))
    out["ms_by_turn"] = runs
    out["ms"] = {name: statistics.median(ms) for name, ms in runs.items()}
    return out


def wide_bwd_turns(torch, ops, ref, libs, l2_bytes):
    """The backward at (192, 128), the sound kernel and each of
    ``WIDE_BWD_PROBES`` (``libs``), at ``WIDE_BWD_SHAPE`` (bf16, causal; o
    and the log-sum-exp from the forward kernel): each one's tight
    readings, then each timed in four turns (order, reversed, order,
    reversed), beside SDPA's backward (its backend named) and the
    bound."""
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    B, S, H, KH, D, Dv = WIDE_BWD_SHAPE
    q, k, v, do = cs.attn_bwd_inputs(torch, B, S, H, KH, D, torch.bfloat16,
                                     dev, 9, dv=Dv)
    o, lse = fa.launch(ops.load_library("flash_attention"), q, k, v,
                       causal=True, with_lse=True)
    args = (q, k, v, o, lse, do)
    fns = {n: (lambda lb: lambda *a: fa.launch_bwd(lb, *a, causal=True))(lb)
           for n, lb in libs.items()}
    out = {"shape": list(WIDE_BWD_SHAPE), "card": cs.card_name_power(),
           "bound_ms": cs.bwd_bound(q, k, v, True), "tight": {}}
    for name, fn in fns.items():
        out["tight"][name] = cs.bwd_rel_l2(torch, ref, fn(*args), *args, True)
        torch.cuda.empty_cache()
    sets, _ = cs.copies(args, l2_bytes)
    runs = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1], list(fns), list(fns)[::-1]):
        for name in order:
            runs[name].append(cs.cuda_ms(torch, fns[name], sets, reps=3,
                                         trials=3))
    out["ms_by_turn"] = runs
    out["ms"] = {name: statistics.median(ms) for name, ms in runs.items()}
    out["sdpa_fwd_bwd_and_fwd_ms"] = cs.sdpa_bwd_ms(
        torch, [(q, k, v, do)], True, reps=3, trials=3)
    out["sdpa_backend"] = cs.sdpa_backend(
        torch, *(t.transpose(1, 2) for t in (q, k, v)), True, False)
    return out


# B, S, nh, hd, ds, dt shift of the SSD backward's probes: zamba2-1.2b's
# train step, then phase 21's bf16 cases at 4096 and 4000 steps, slow decay
# (the last at ds 128, one stage of head tiles)
SSD_BWD_CASES = [(4, 4096, 64, 64, 64, 0.0),
                 (1, 4096, 4, 64, 64, cs.SLOW_DT_SHIFT),
                 (1, 4000, 2, 64, 128, cs.SLOW_DT_SHIFT)]


# B, S, di, ds, dt shift of the selective-scan backward's probes:
# falcon-mamba-7b's train step, then phase 23's cases of 4096 slowly
# decaying steps and of a ragged last tile at ds 8
SCAN_BWD_CASES = [(4, 4096, 8192, 16, 0.0),
                  (1, 4096, 512, 16, cs.SLOW_DT_SHIFT),
                  (2, 4095, 256, 8, 0.0)]




def _scan_bwd_bound(torch, step):
    dev = torch.device("cuda")
    return cs.scan_bwd_bound(
        *step[:-1], torch.cuda.get_device_properties(dev).multi_processor_count,
        cs.max_sm_clock_hz(torch, dev))[0]


# each backward library the turns below read: its cases, its forward
# library and launcher module, its inputs' maker and seeds (inputs, output
# gradient), its gradients' names and its bound (and the SSD's byte floor)
BWD_TURNS = {
    "ssd_chunk_bwd": dict(
        cases=SSD_BWD_CASES, fwd="ssd_chunk", module="ssd_chunk",
        inputs=cs.ssd_inputs, seeds=(900, 950), names=cs.SSD_BWD_NAMES,
        bound=lambda torch, step: cs.ssd_bwd_bound(*step[:-1])[0],
        floor=lambda step: cs.ssd_bwd_design_floor(*step)),
    "selective_scan_bwd": dict(
        cases=SCAN_BWD_CASES, fwd="selective_scan", module="selective_scan",
        inputs=cs.scan_inputs, seeds=(980, 990), names=cs.SCAN_BWD_NAMES,
        bound=_scan_bwd_bound, floor=None)}


def bwd_turns(torch, ops, ref, lib, libs, parent, l2_bytes):
    """The bf16 backward ``lib`` (a key of ``BWD_TURNS``) of each library
    in ``libs`` (the sound one and the probes) and (``parent``: a launch
    function, or None) the parent's: each one's tight readings (relative
    L2 of each gradient from the f32 backward of the same inputs) on the
    library's cases and whether they hold phase 21's / 23's limits (the
    states from this checkout's forward kernel), then each timed at the
    first case (the train step's shape) in four turns (order, reversed,
    order, reversed), beside the bound (and the SSD's design's byte
    floor)."""
    spec = BWD_TURNS[lib]
    mod = importlib.import_module(f"repro_torch.kernels.{spec['module']}")
    dev = torch.device("cuda")
    fwd = ops.load_library(spec["fwd"])
    fns = {n: (lambda lb: lambda *a: mod.launch_bwd(lb, *a))(lb)
           for n, lb in libs.items()}
    if parent is not None:
        fns = {"parent": parent, **fns}
    out = {"card": cs.card_name_power(),
           "cases": [list(c) for c in spec["cases"]],
           "tight": {n: {} for n in fns}, "holds": dict.fromkeys(fns, True)}
    for i, case in enumerate(spec["cases"]):
        args = spec["inputs"](torch, *case[:-1], torch.bfloat16, dev,
                              spec["seeds"][0] + i, case[-1])
        dy = cs.output_grad(torch, tuple(args[0].shape), torch.bfloat16,
                            dev, spec["seeds"][1] + i)
        _, states = mod.launch(fwd, *args, with_states=True)
        exact = getattr(ref, lib)(*(a.float() for a in args), dy.float())
        label = "x".join(map(str, case[:-1])) + f" shift {case[-1]}"
        for name, fn in fns.items():
            grads = fn(*args, dy, states)
            out["tight"][name][label] = cs.grad_readings(
                torch, grads, exact, spec["names"])
            try:
                cs.hold_grads(torch, grads, exact, spec["names"], label)
            except cs.SmokeFailure:
                out["holds"][name] = False
            del grads
        del exact
        if i == 0:
            step = (*args, dy, states)
        del args, dy, states
        torch.cuda.empty_cache()
        cs.log(json.dumps({f"{lib}_tight": {
            n: out["tight"][n][label] for n in fns}}))
    sets, _ = cs.copies(step, l2_bytes)
    runs = {n: [] for n in fns}
    for order in (list(fns), list(fns)[::-1], list(fns), list(fns)[::-1]):
        for name in order:
            runs[name].append(cs.cuda_ms(torch, fns[name], sets, reps=5))
    out["ms_by_turn"] = runs
    out["ms"] = {n: statistics.median(ms) for n, ms in runs.items()}
    out["bound_ms"] = spec["bound"](torch, step)
    if spec["floor"] is not None:
        out["design_floor_ms"] = spec["floor"](step)
    return out


def f32_excess(torch, ref, libs, launch, args):
    """Each library's f32 output against the plain version: the largest
    ``|got - exp| - tol (1 + |exp|)`` at ``SCAN_TOL``'s f32 tolerance (> 0
    fails chip_smoke.py's check) and the largest abs error."""
    exp = ref.selective_scan(*args)
    tol = cs.SCAN_TOL["float32"]
    out = {}
    for name, lib in libs.items():
        err = (launch(lib, *args) - exp).abs()
        out[name] = {"max_abs": float(err.max()),
                     "excess": float((err - tol * (1 + exp.abs())).max())}
    return out


def engine_replays(tree, rounds=4, runs=2):
    """Seconds of each replayed step of the fused engines of the checkout
    at ``tree`` (its package put first on the path, so ``chip_smoke``'s
    helpers time it), in this process: ``{engine: [replays of each
    run]}``."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from repro_torch.federated import replay
    from repro_torch.federated.async_server import run_fl_async_scanned
    from repro_torch.federated.server import run_fl_scanned
    from repro_torch.kernels import ops

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.load_library("topk_select")
    dev = torch.device("cuda")
    engines = {
        "run_fl_scanned": (run_fl_scanned,
                           cs.fl_config(10_000, 100, rounds)),
        "run_fl_async_scanned": (run_fl_async_scanned, cs.fl_config(
            10_000, 100, rounds, buffer_size=cs.ASYNC_BUFFER,
            max_concurrency=cs.ASYNC_CONCURRENCY,
            staleness_power=cs.ASYNC_POWER))}
    out = {}
    for name, (fn, cfg) in engines.items():
        out[name] = []
        for _ in range(runs):
            times = []
            with cs.replay_timing(torch, replay, times):
                fn(cfg, device=dev)
            out[name].append(times[1:])
    return out


# each scan arch's train-step phase of chip_smoke.py and the libraries it
# launches
TRAIN_ARCHS = {"zamba2-1.2b": (22, ("ssd_chunk", "ssd_chunk_bwd",
                                    "flash_attention", "flash_attention_bwd")),
               "falcon-mamba-7b": (24, ("selective_scan",
                                        "selective_scan_bwd"))}


def train_step(tree, seed, arch="zamba2-1.2b"):
    """``arch``'s train step as ``chip_smoke.py``'s phase 22 (zamba2-1.2b)
    or 24 (falcon-mamba-7b) runs it (3 steps at 4 x 4096, a fourth
    profiled, the routes), the package of the checkout at ``tree`` put
    first on the path, in this process: its step times, tokens/s, peak
    memory and the profiled step's device time by layer."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from repro_torch.kernels import ops, ref

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase, libs = TRAIN_ARCHS[arch]
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(ops.build_library, libs))
    row, _ = cs.phase_scan_train_step(torch, ops, ref, torch.device("cuda"),
                                      seed, arch, phase)
    prof = row["profile"]
    return {"step_s": row["step_s"], "tokens_per_s": row["tokens_per_s"],
            "peak_gib": row["peak_gib"], "busy_ms": prof["device_busy_ms"],
            "idle_share": prof["idle_share"], "by_kind_ms": prof["by_kind_ms"]}


def in_turns(other, flag, key, extra=()) -> int:
    """Run this script with ``flag`` for ``other`` and for this checkout in
    turns (other, this, this, other), a process each, and log each run's
    last line under ``key``."""
    readings = []
    for tree in (other, cs.ROOT, cs.ROOT, other):
        proc = subprocess.run(
            [sys.executable, __file__, flag, str(tree), *extra],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        readings.append({"tree": str(tree), **json.loads(
            proc.stdout.strip().splitlines()[-1])})
        cs.log(json.dumps(readings[-1]))
    cs.log(json.dumps({"card": cs.card_name_power(), key: readings}))
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=cs.SEED,
                    help="weights and tokens, as chip_smoke.py's")
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="another checkout whose SSD and scan kernels are "
                    "timed beside this one's")
    ap.add_argument("--engines", metavar="DIR", default=None,
                    help="time the fused engines' replayed steps of "
                    "another checkout and of this one in turns instead")
    ap.add_argument("--engine-run", metavar="DIR", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--train-steps", metavar="DIR", default=None,
                    help="time a scan arch's train step (phase 22 or 24) "
                    "of another checkout and of this one in turns instead")
    ap.add_argument("--train-run", metavar="DIR", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--arch", choices=tuple(TRAIN_ARCHS),
                    default="zamba2-1.2b",
                    help="the arch of --train-steps")
    ap.add_argument("--only", choices=tuple(PARTS), default=None,
                    help="run one part of the probes")
    opts = ap.parse_args(argv)
    seed = opts.seed
    if opts.train_run:   # as chip_smoke.py's main, before torch starts
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_probes: no CUDA device", file=sys.stderr)
        return 2
    if opts.engine_run:
        print(json.dumps(engine_replays(opts.engine_run)))
        return 0
    if opts.train_run:
        print(json.dumps(train_step(opts.train_run, seed, opts.arch)))
        return 0
    if opts.engines:
        return in_turns(opts.engines, "--engine-run", "engine_replays_s")
    if opts.train_steps:
        return in_turns(opts.train_steps, "--train-run", "train_steps",
                        ("--seed", str(seed), "--arch", opts.arch))
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cs.log(f"card {cs.card_name_power()}")
    scans, attn, ssd_bwd, scan_bwd, wide = (opts.only in (None, part)
                                            for part in PARTS)
    parts = tuple(n for part in PARTS if opts.only in (None, part)
                  for n in PARTS[part])
    parent, sass, libs, ssd_bwd_libs, scan_bwd_libs = {}, {}, {}, {}, {}
    wide_libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        if wide:
            ops.load_library("flash_attention")
            wide_libs = build_bwd_probes(ops, "flash_attention_bwd",
                                         WIDE_BWD_PROBES, tmp)
        if ssd_bwd:
            ops.load_library("ssd_chunk")
            ssd_bwd_libs = build_bwd_probes(ops, "ssd_chunk_bwd",
                                            SSD_BWD_PROBES, tmp)
        if scan_bwd:
            ops.load_library("selective_scan")
            scan_bwd_libs = build_bwd_probes(ops, "selective_scan_bwd",
                                             SCAN_BWD_PROBES, tmp)
            sass["scan_bwd"] = {"this": cs.loop_counts(ops, {
                "selective_scan_bwd": ops.library_path(
                    "selective_scan_bwd")})["selective_scan_bwd"]}
        if scans:
            libs = build_probes(ops, tmp)
            sass["this"] = cs.loop_counts(
                ops, {n: ops.library_path(n) for n in PROBES})
        if attn:
            secs = {}
            for lib in ("flash_attention", "flash_attention_bwd"):
                t0 = time.perf_counter()
                ops.load_library(lib)
                secs[lib] = round(time.perf_counter() - t0, 2)
            cs.log(f"this checkout's attention libraries built with nvcc "
                   f"(or found built), s each, one after the other: {secs}")
            bwd_paths = {"this": ops.library_path("flash_attention_bwd")}
        if opts.parent:
            parent, paths = load_parent(ops, opts.parent, tmp, parts)
            if scans:
                src = (Path(opts.parent) / "src" / "repro_torch" / "kernels" /
                       "csrc" / "ssd_chunk.cu").read_text()
                sass["parent"] = cs.loop_counts(
                    ops, {n: paths[n] for n in PROBES},
                    cs.MAIN_ENTRIES["ssd_chunk"]
                    if "ssd_fwd_mma" in src else FIRST_SSD_ENTRY)
            if attn:
                bwd_paths["parent"] = paths["flash_attention_bwd"]
            if scan_bwd:
                src = (Path(opts.parent) / "src" / "repro_torch" / "kernels" /
                       "csrc" / "selective_scan_bwd.cu").read_text()
                sass["scan_bwd"]["parent"] = cs.loop_counts(
                    ops, {"selective_scan_bwd": paths["selective_scan_bwd"]},
                    scan_bwd_entry=cs.MAIN_ENTRIES["selective_scan_bwd"]
                    if "scan_bwd_cluster" in src
                    else FIRST_SCAN_BWD_ENTRY)["selective_scan_bwd"]
        if attn:
            sass["attention_bwd"] = bwd_sass(ops, bwd_paths)
    cs.log(json.dumps({"sass": sass}))
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    readings = {}
    if attn:
        readings["flash_attention_bwd"] = attention_bwd_turns(
            torch, ops, ref, parent.get("flash_attention_bwd"), l2)
        cs.log(json.dumps({"flash_attention_bwd":
                           readings["flash_attention_bwd"]}))
    if wide:
        readings["flash_attention_bwd_wide"] = wide_bwd_turns(
            torch, ops, ref, wide_libs, l2)
        cs.log(json.dumps({"flash_attention_bwd_wide":
                           readings["flash_attention_bwd_wide"]}))
    if ssd_bwd:
        readings["ssd_chunk_bwd"] = bwd_turns(
            torch, ops, ref, "ssd_chunk_bwd", ssd_bwd_libs,
            parent.get("ssd_chunk_bwd"), l2)
        cs.log(json.dumps({"ssd_chunk_bwd": readings["ssd_chunk_bwd"]}))
    if scan_bwd:
        readings["selective_scan_bwd"] = bwd_turns(
            torch, ops, ref, "selective_scan_bwd", scan_bwd_libs,
            parent.get("selective_scan_bwd"), l2)
        cs.log(json.dumps({"selective_scan_bwd":
                           readings["selective_scan_bwd"]}))
    if scans:
        scan_probes(torch, ops, ref, dev, seed, libs, parent, l2, readings)
    cs.log(json.dumps({"limits": {"ssd_chunk": cs.SSD_BF16_REL_L2,
                                  "ssd_chunk_bwd": {
                                      "bf16": cs.SCAN_BWD_BF16_REL_L2,
                                      "f32": cs.SCAN_BWD_F32_REL_L2,
                                      "bf16_from_entries":
                                          cs.TIGHT_MIN_SIZE},
                                  "ssd_chunk_slow_decay":
                                      cs.SSD_BF16_REL_L2_SLOW,
                                  "selective_scan": cs.SCAN_BF16_REL_L2,
                                  "f32": cs.SCAN_TOL["float32"],
                                  "flash_attention_bwd":
                                      cs.ATTN_BWD_BF16_REL_L2},
                       "readings": readings, "sass": sass}))
    return 0


def scan_probes(torch, ops, ref, dev, seed, libs, parent, l2, readings):
    """The SSD and scan probes' tight readings and times (beside the
    parent's kernels where ``parent`` has them) into ``readings``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.models.transformer import forward_logits, init_params

    def first_call(arch, lib):
        cfg = get_config(arch)
        params = init_params(seed, cfg, device=dev)
        with cs.first_calls(ops, (lib,)) as seen:
            forward_logits(cfg, params, cf.prefill_tokens(torch, cfg, seed,
                                                          dev), device=dev)
        del params
        torch.cuda.empty_cache()
        return seen[lib][0]

    for lib, launch, cases, limits in (
            ("ssd_chunk", sc.launch, cf.ssd_cases, cf.ssd_limits),
            ("selective_scan", ss.launch, cf.scan_cases,
             lambda inputs: dict.fromkeys(inputs, cs.SCAN_BF16_REL_L2))):
        arch = {"ssd_chunk": "zamba2-1.2b",
                "selective_scan": "falcon-mamba-7b"}[lib]
        inputs = cases(torch, ref, dev, first_call(arch, lib))
        r = cf.scan_readings(torch, libs[lib], launch, inputs,
                             limits(inputs), lib)
        fns = {n: (lambda lb: lambda *a: launch(lb, *a))(lb)
               for n, lb in libs[lib].items()}
        if parent:
            fns = {"parent": parent[lib], **fns}
        for name, ms in times(torch, fns, inputs["prefill_call"][0],
                              l2).items():
            r.setdefault(name, {})["ms"] = ms
        cs.log(json.dumps({f"{lib}_ms": {n: v["ms"] for n, v in r.items()}}))
        del inputs
        readings[lib] = r
    # the scan's f32 route on the prefill shape with slow decay (phase 12)
    slow = [c for c in cs.SCAN_SHAPES if c[:4] == (2, 4096, 8192, 16)
            and c[4] == cs.SLOW_DT_SHIFT][0]
    args32 = cs.scan_inputs(torch, *slow[:4], torch.float32, dev,
                            200 + cs.SCAN_SHAPES.index(slow), slow[4])
    for name, r in f32_excess(torch, ref, libs["selective_scan"], ss.launch,
                              args32).items():
        readings["selective_scan"][name]["f32_slow_decay"] = r


if __name__ == "__main__":
    sys.exit(main())
