"""Dry-run: trace every (arch x input-shape x mesh) on fake tensors.

The port's ``repro/launch/dryrun.py``. Where the reference lowers and
compiles each step onto its TPU pod meshes and reads XLA's cost and
memory analyses, this traces the port's step functions
(``launch/steps.py``) on ``FakeTensor`` inputs (``launch/specs.py``) at
full width: nothing is allocated on any device and no kernel is built or
launched (each kernel wrapper takes its fake route, ``kernels/counting.py``).
:func:`~repro_torch.launch.roofline.count_step` counts the dot FLOPs and
the live bytes, and :func:`~repro_torch.launch.roofline.analyze` divides
them by the card's rates (``configs/base.py::H100_SXM``). Nothing is set
at import.

The mesh is the one-device host mesh (the reference's ``make_host_mesh``,
1 x 1): on one device every sharding strategy places each tensor whole,
so each is accepted and recorded and they give the same numbers. The pod
meshes (``single``, ``multi``, ``both``) need the LM sharding strategies
as DTensor placements and a fake process group: they are ROADMAP.md item
18, and asking for one raises ``ValueError``.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --device cpu --out dryrun.jsonl

``--device cpu`` describes fake CPU tensors and runs on any build;
``--device cuda`` (the default) describes the card's and needs a CUDA
build of PyTorch (a CPU-only build cannot fake CUDA views).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import traceback
from typing import Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import roofline as rl
from repro_torch.launch.specs import cache_specs, input_specs, params_specs
from repro_torch.launch.steps import (default_optimizer, make_prefill_step,
                                      make_serve_step, make_train_step)

# the reference's LM sharding strategies (repro/launch/sharding.py)
STRATEGIES = ("baseline", "fsdp", "serve_tp", "ep_fsdp")
MESHES = ("host", "single", "multi", "both")
HOST_MESH = (1, 1)                     # ("data", "model"), one device
SERVE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def check_mesh(mesh: str) -> None:
    """Refuse the pod meshes, which wait for ROADMAP.md item 18."""
    if mesh not in MESHES:
        raise ValueError(f"unknown mesh {mesh!r}; known: {MESHES}")
    if mesh != "host":
        raise ValueError(
            f"--mesh {mesh}: the 16 x 16 and 2 x 16 x 16 pod meshes need the "
            f"LM sharding strategies as DTensor placements and a fake "
            f"process group, ROADMAP.md item 18 (the production meshes); "
            f"this dry-run runs on the one-device host mesh (--mesh host)")


def step_and_args(cfg: ModelConfig, shape: InputShape, dev: torch.device):
    """The step function of ``shape.mode`` and its fake arguments, made in
    the caller's ``FakeTensorMode``: train ``(params, AdamW state,
    batch)``, prefill ``(params, batch)``, decode ``(params, batch, cache,
    cache_index)`` with the new token at the cache's last position."""
    params = params_specs(cfg, dev)
    batch = input_specs(cfg, shape, dev)
    if shape.mode == "train":
        opt = default_optimizer()
        step = make_train_step(cfg, opt, device=dev, use_kernel=True)
        return step, (params, opt.init(params), batch)
    if shape.mode == "prefill":
        return make_prefill_step(cfg, dev, use_kernel=True), (params, batch)
    ring = bool(shape.sliding_window) and cfg.attn_kind != "none"
    cache = cache_specs(cfg, shape, dev)
    return (make_serve_step(cfg, ring=ring, device=dev),
            (params, batch, cache, shape.seq_len - 1))


def trace_one(cfg: ModelConfig, shape: InputShape, device: DeviceLike = None,
              strategy: str = "baseline"
              ) -> Tuple[rl.RooflineReport, rl.StepCount]:
    """Trace ``cfg``'s step of ``shape`` on fake tensors of ``device`` (the
    card unless ``"cpu"``) in a ``FakeTensorMode`` of its own, the kernels
    through their fake routes, on the host mesh under ``strategy``;
    returns the roofline report and the count. Allocates nothing and
    launches nothing."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; known: "
                         f"{STRATEGIES}")
    dev = resolve_device(device)
    with FakeTensorMode():
        step, args = step_and_args(cfg, shape, dev)
        count = rl.count_step(step, *args)
        del step, args
    gc.collect()
    return rl.analyze(cfg, shape, HOST_MESH, count.dot_flops, count), count


def run_one(arch: str, shape_name: str, mesh: str = "host", verbose=True,
            strategy: str = "baseline", serve_dtype: Optional[str] = None,
            device: DeviceLike = None) -> Dict:
    """:func:`trace_one` of a named arch and shape; returns the record the
    CLI writes, and prints the reference's lines."""
    check_mesh(mesh)
    cfg = get_config(arch)
    if serve_dtype is not None:
        cfg = cfg.with_(param_dtype=SERVE_DTYPES[serve_dtype])
    shape = INPUT_SHAPES[shape_name]
    report, count = trace_one(cfg, shape, device, strategy)
    rec = {
        "arch": arch, "shape": shape_name, "strategy": strategy,
        "mesh": list(HOST_MESH), "device": str(resolve_device(device)),
        "serve_dtype": serve_dtype, "trace_s": round(count.trace_s, 2),
        "memory_analysis": (
            f"arguments {report.argument_bytes / 2**30:.3f} GiB, peak live "
            f"{report.peak_mem_bytes / 2**30:.3f} GiB "
            f"({report.peak_mem_bytes} bytes)"),
        "argument_bytes": report.argument_bytes,
        "peak_live_bytes": report.peak_mem_bytes,
        "dot_flops_per_dev": report.dot_flops_per_dev,
        "flops_by_op": report.flops_by_op,
        "analytic_bytes_per_dev": report.analytic_bytes_per_dev,
        "collective_bytes_per_dev": report.collective_bytes_per_dev,
        "collective_by_type": report.collective_by_type,
        "t_compute": report.t_compute, "t_memory": report.t_memory,
        "t_collective": report.t_collective, "dominant": report.dominant,
        "model_flops_total": report.model_flops_total,
        "useful_ratio": report.useful_ratio,
    }
    if verbose:
        print(f"== {arch} x {shape_name} x mesh{rec['mesh']} [{strategy}] ==")
        print(f"   trace {count.trace_s:.1f}s on fake {rec['device']} "
              f"tensors")
        print(f"   memory_analysis: {rec['memory_analysis']}")
        print(f"   dot flops: {report.dot_flops_per_dev:.4e} "
              f"({report.flops_by_op})")
        print(f"   roofline: compute={report.t_compute:.3e}s "
              f"memory={report.t_memory:.3e}s "
              f"collective={report.t_collective:.3e}s "
              f"-> dominant={report.dominant} "
              f"useful={report.useful_ratio:.2f}")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    ap.add_argument("--mesh", choices=list(MESHES), default="host")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--strategy", choices=list(STRATEGIES),
                    default="baseline")
    ap.add_argument("--serve-dtype", choices=list(SERVE_DTYPES),
                    default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="the device the fake tensors describe (the card "
                         "by default)")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)
    check_mesh(args.mesh)

    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or not args.shape \
        else [args.shape]
    failures = []
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            try:
                rec = run_one(arch, shape, args.mesh,
                              strategy=args.strategy,
                              serve_dtype=args.serve_dtype,
                              device=args.device)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
            except Exception:
                failures.append((arch, shape, args.mesh))
                traceback.print_exc()
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print(f"dry-run OK: {len(archs) * len(shapes)} combinations "
          f"({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
