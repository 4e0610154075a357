#!/usr/bin/env python3
"""Plant faults in the tensor-core attention kernel and read what
``chip_smoke.py``'s checks make of them, on one GPU.

    python3 chip_faults.py [--seed N]   # needs one CUDA device

Each fault in ``FAULTS`` is one edit of ``flash_fwd_mma`` in
``src/repro_torch/kernels/csrc/flash_attention.cu``, built with the
library's own flags into a temporary directory (the checkout is left as
it is). For the sound kernel and for each fault it prints one JSON line:

- ``tight``: the tight check of ``chip_smoke.py`` (phases 7 and 9), the
  relative L2 distance of the bf16 output from the f32 attention of the
  same bf16 inputs, at the prefill shape (2, 4096, 32, 64) causal and on
  the first attention call of a full-width zamba2-1.2b prefill, against
  ``ATTN_BF16_REL_L2``;
- ``route_ratio``: phase 9's bf16 sanity check, the kernel route's
  relative L2 distance from the f32 logits of the 2 x 4096 prefill over
  the plain route's, against ``BF16_ROUTE_RATIO``;
- ``replay_rel_l2``: phase 10's, the kernel-route forward over the serve
  prompt (batch 4, 32 tokens) at its last position against the decode
  loop's replay, against ``BF16_REPLAY_REL_L2``.

Exits 1 unless the sound kernel passes the tight check and every fault
fails it. The last line is one JSON object with all the readings.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs

# name: (text in flash_fwd_mma, its replacement); each text occurs once
FAULTS = {
    "output_scaled_1.05": (
        "const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);",
        "const float d0 = 1.05f * fmaxf(l0, 1e-30f),\n"
        "              d1 = 1.05f * fmaxf(l1, 1e-30f);"),
    "first_k_tile_skipped": (
        "    __syncthreads();  // every warp is done with the last K/V tile",
        "    if (kt == 0 && n_tiles > 1) continue;\n"
        "    __syncthreads();  // every warp is done with the last K/V tile"),
    "diagonal_masked": (
        "if (col >= S || (causal && col > row0)) x0 = kNegInf;\n"
        "        if (col >= S || (causal && col > row1)) x1 = kNegInf;",
        "if (col >= S || (causal && col >= row0)) x0 = kNegInf;\n"
        "        if (col >= S || (causal && col >= row1)) x1 = kNegInf;"),
    "accumulator_not_rescaled": (
        "      acc[n][0] *= corr0;\n      acc[n][1] *= corr0;\n"
        "      acc[n][2] *= corr1;\n      acc[n][3] *= corr1;\n",
        ""),
    "accumulator_in_bf16": (
        "      acc[n][0] *= corr0;\n      acc[n][1] *= corr0;\n"
        "      acc[n][2] *= corr1;\n      acc[n][3] *= corr1;\n",
        "#pragma unroll\n      for (int e = 0; e < 4; ++e)\n"
        "        acc[n][e] = __bfloat162float(__float2bfloat16_rn(\n"
        "            acc[n][e] * (e < 2 ? corr0 : corr1)));\n"),
}


def build_fault(ops, name, old, new, tmp):
    """Compile the library with one fault planted; returns its path."""
    src = (ops.CSRC / "flash_attention.cu").read_text()
    cs.check(src.count(old) == 1, f"fault {name}: its text occurs "
             f"{src.count(old)} times in flash_attention.cu, not once")
    cu = Path(tmp) / f"{name}.cu"
    cu.write_text(src.replace(old, new))
    out = Path(tmp) / f"lib{name}.so"
    proc = subprocess.run([ops._nvcc(), *ops.nvcc_flags("flash_attention"),
                           "-o", str(out), str(cu)],
                          capture_output=True, text=True)
    cs.check(proc.returncode == 0, f"nvcc failed for fault {name}:\n"
             f"{proc.stderr}")
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=cs.SEED,
                    help="weights and tokens, as chip_smoke.py's")
    seed = ap.parse_args(argv).seed
    import torch
    if not torch.cuda.is_available():
        print("chip_faults: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import forward_logits, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    cs.log(f"card {smi.stdout.strip()}")

    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(FAULTS) + 1) as pool:
            sound = pool.submit(ops.build_library, "flash_attention")
            built = {n: pool.submit(build_fault, ops, n, o, w, tmp)
                     for n, (o, w) in FAULTS.items()}
            sound.result()
            libs = {"sound": ops.load_library("flash_attention")}
            libs.update({n: fa.bind(ctypes.CDLL(str(f.result())))
                         for n, f in built.items()})

        # inputs: phase 7's at the prefill shape, the prefill's first call
        synth = cs.attn_inputs(torch, 2, 4096, 32, 32, 64, torch.bfloat16,
                               dev, 1)
        cfg = get_config("zamba2-1.2b")
        params = init_params(seed, cfg, device=dev)
        g = torch.Generator(device="cpu").manual_seed(seed)
        tokens = torch.randint(0, cfg.vocab_size,
                               (cs.PREFILL_BATCH, cs.PREFILL_LEN),
                               generator=g).to(dev)
        batch = {"tokens": tokens}
        with cs.first_calls(ops, ("flash_attention",)) as seen:
            forward_logits(cfg, params, batch, device=dev)
        call = seen["flash_attention"][0]
        cfg32 = cfg.with_(compute_dtype=torch.float32)
        exact = forward_logits(cfg32, params, batch, device=dev,
                               use_kernel=False)
        plain = forward_logits(cfg, params, batch, device=dev,
                               use_kernel=False)
        plain_d = cs.logit_diff(torch, plain, exact, "plain")["rel_l2"]
        del plain
        g = torch.Generator(device="cpu").manual_seed(seed + 1)
        prompt = torch.randint(0, cfg.vocab_size, (4, 32),
                               generator=g).to(dev)
        replay = generate(cfg, params, prompt, 16,
                          device=dev).prompt_logits

        readings = {}
        for name, lib in libs.items():
            ops._LIBS["flash_attention"] = lib
            tight = {"prefill_shape": cs.attn_rel_l2(
                         torch, ref, fa.launch(lib, *synth), *synth, True),
                     "prefill_call": cs.attn_rel_l2(
                         torch, ref, fa.launch(lib, *call), *call, True)}
            logits = forward_logits(cfg, params, batch, device=dev)
            route = cs.logit_diff(torch, logits, exact, name)["rel_l2"]
            del logits
            fwd = forward_logits(cfg, params, {"tokens": prompt}, device=dev)
            r = {"tight": tight,
                 "tight_fails": max(tight.values()) > cs.ATTN_BF16_REL_L2,
                 "route_ratio": route / plain_d,
                 "route_fails": route / plain_d > cs.BF16_ROUTE_RATIO,
                 "replay_rel_l2": cs.logit_diff(   # as phase 10 reads it
                     torch, replay, fwd[:, -1:], name)["rel_l2"]}
            r["replay_fails"] = r["replay_rel_l2"] > cs.BF16_REPLAY_REL_L2
            readings[name] = r
            cs.log(json.dumps({name: r}))
        ops._LIBS["flash_attention"] = libs["sound"]
        del libs

    limits = {"tight": cs.ATTN_BF16_REL_L2,
              "route_ratio": cs.BF16_ROUTE_RATIO,
              "replay_rel_l2": cs.BF16_REPLAY_REL_L2}
    ok = not readings["sound"]["tight_fails"] and all(
        r["tight_fails"] for n, r in readings.items() if n != "sound")
    cs.log(json.dumps({"ok": ok, "limits": limits, "readings": readings}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
