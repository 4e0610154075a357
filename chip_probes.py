#!/usr/bin/env python3
"""Design probes of the two bf16 scan kernels, and their times beside
another checkout's kernels, on one GPU.

    python3 chip_probes.py [--seed N] [--parent DIR]   # one CUDA device

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
  part.

For the sound kernel and each probe it prints the tight check of
``chip_faults.py`` (phase 8's and 12's bf16 cases at the prefill shape,
fast and slow decay, and the first call of a full-width prefill), the
milliseconds a call on that prefill call's inputs (as ``chip_smoke.py``
phases 11 and 16 time the kernels, in turns) and, for the selective scan,
the f32 route's largest error on the prefill shape with slow decay
against ``SCAN_TOL``'s f32 tolerance. A probe whose text no longer occurs
once in its source stops the script.

``--parent DIR`` also builds the SSD and scan sources of another checkout
(say the parent commit's, unpacked by ``git archive``) with this
checkout's flags, launches them through that checkout's own launchers,
times them in the same turns (first in the first turn, last in the
second) and reads the SASS loop counts of both checkouts' kernels as
``chip_smoke.py``'s phase 1 does. The last line is one JSON object with
all the readings; without a CUDA device it exits 2.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
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
# the first SSD kernel's bf16 entry (one CTA of full hd a (batch, head),
# scalar FMAs), counted where a checkout has no tensor-core kernel
FIRST_SSD_ENTRY = "ssd_fwdI13__nv_bfloat16Li64ELi64E"


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


def load_parent(ops, root, out_dir, names=("ssd_chunk", "selective_scan")):
    """The kernels of another checkout ``root``: each library built from
    ``root``'s source with this checkout's flags into ``out_dir``, one nvcc
    each, and launched by ``root``'s own launcher module. Returns
    ``({name: fn(*args)}, {name: library path})``."""
    kdir = Path(root).resolve() / "src" / "repro_torch" / "kernels"

    def build(name):
        so = Path(out_dir) / f"libparent_{name}.so"
        proc = subprocess.run([ops._nvcc(), *ops.nvcc_flags(name), "-o",
                               str(so), str(kdir / "csrc" / f"{name}.cu")],
                              capture_output=True, text=True)
        cs.check(proc.returncode == 0, f"nvcc failed for {root}'s {name}:\n"
                 f"{proc.stderr[-2000:]}")
        return so

    with ThreadPoolExecutor(len(names)) as pool:
        sos = dict(zip(names, pool.map(build, names)))
    fns = {}
    for name in names:
        spec = importlib.util.spec_from_file_location(f"parent_{name}",
                                                      kdir / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        lib = mod.bind(ctypes.CDLL(str(sos[name])))
        fns[name] = (lambda m, lb: lambda *a: m.launch(lb, *a))(mod, lib)
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


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=cs.SEED,
                    help="weights and tokens, as chip_smoke.py's")
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="another checkout whose SSD and scan kernels are "
                    "timed beside this one's")
    opts = ap.parse_args(argv)
    seed = opts.seed
    import torch
    if not torch.cuda.is_available():
        print("chip_probes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.models.transformer import forward_logits, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cs.log(f"card {cs.card_name_power()}")
    parent, sass = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_probes(ops, tmp)
        sass["this"] = cs.loop_counts(
            ops, {n: ops.library_path(n) for n in PROBES})
        if opts.parent:
            parent, paths = load_parent(ops, opts.parent, tmp)
            src = (Path(opts.parent) / "src" / "repro_torch" / "kernels" /
                   "csrc" / "ssd_chunk.cu").read_text()
            sass["parent"] = cs.loop_counts(
                ops, paths, cs.MAIN_ENTRIES["ssd_chunk"]
                if "ssd_fwd_mma" in src else FIRST_SSD_ENTRY)
    cs.log(json.dumps({"sass": sass}))
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size

    def first_call(arch, lib):
        cfg = get_config(arch)
        params = init_params(seed, cfg, device=dev)
        with cs.first_calls(ops, (lib,)) as seen:
            forward_logits(cfg, params, cf.prefill_tokens(torch, cfg, seed,
                                                          dev), device=dev)
        del params
        torch.cuda.empty_cache()
        return seen[lib][0]

    readings = {}
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
    cs.log(json.dumps({"limits": {"ssd_chunk": cs.SSD_BF16_REL_L2,
                                  "ssd_chunk_slow_decay":
                                      cs.SSD_BF16_REL_L2_SLOW,
                                  "selective_scan": cs.SCAN_BF16_REL_L2,
                                  "f32": cs.SCAN_TOL["float32"]},
                       "readings": readings, "sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
