#!/usr/bin/env python3
"""Plant faults in the top-k, tensor-core attention (forward and
backward) and both scan kernels and in the async (FedBuff) engines, and
read what ``chip_smoke.py``'s checks make of them, on one GPU.

    python3 chip_faults.py [--seed N]   # needs one CUDA device

Each fault is one edit of a kernel source under
``src/repro_torch/kernels/csrc/``, built with the library's own flags into
a temporary directory (the checkout is left as it is; the sources'
directory is on the include path for ``hopper.cuh``): ``TOPK_FAULTS``
edit ``topk_select`` in ``topk_select.cu`` (2), ``FAULTS``
``flash_fwd_wgmma`` in ``flash_attention.cu`` (5), ``SSD_FAULTS`` the
tensor-core ``ssd_fwd_mma`` in ``ssd_chunk.cu`` (6) and ``SCAN_FAULTS``
``scan_fwd`` in ``selective_scan.cu`` (6). ``BWD_FAULTS`` (4) are one or
more edits each of the training path's attention: the backward kernel
``flash_bwd_wgmma`` with dK not summed over the query heads of a KV head,
with the last, ragged key tile's rows past S read (K and V mapped as one
sequence over the batches) and not masked, and with dS^T stored without
the swizzle that dQ's descriptor reads; and the tensor-core forward's
log-sum-exp left in base 2. Phase 17 of ``chip_smoke.py`` must pass with
the sound libraries and fail with each fault. ``WIDTH_FAULTS`` (3) edit
the attention kernels at the width pairs of the dense and MLA archs: the
forward's Q K^T without the q.k columns 64-95 at a width of 96, the
forward's scale taken from v's width instead of the q.k width, and the
backward's dV summed over dO's stage tiles laid out at the q.k width;
phase 26 must pass with the sound libraries and fail with each.
``WIDE_FAULTS`` (4) edit both kernels at deepseek-v2-236b's (192, 128):
the forward's Q K^T without the third 64-column box of q and k, and in
the backward's ``flash_bwd_wgmma_wide`` dK's third box never accumulated,
the two consumer warpgroups' dV columns swapped, and the P^T and dS^T
tiles stored without their swizzle; phase 32 must pass with the sound
libraries and fail with each, and the backward's tight check alone
(``WIDE_TIGHT_SHAPES``) must pass the sound kernel and reject each
backward fault.
``SCAN_BWD_FAULTS`` (15)
edit the scan backward kernels: in the f32 route's ``ssd_bwd``
(``ssd_chunk_bwd.cu``) the gradient carried into the chunk before not
decayed across the chunk boundary, dA without its even steps' terms, and
dB summed over one head's CTA only; in the bf16 route's carry pass
``ssd_bwd_carry`` K not decayed across the chunk boundary, and in its
``ssd_bwd_local`` dA without its even steps' terms, dB summed over the
CTA's first head only, and Dm's low part dropped from Dm^T dy; in
``scan_bwd_cluster`` (``selective_scan_bwd.cu``) g carried into the tile
before without the decay of the tile's first step, dA's terms without the
step's decay, dB summed over the cluster's first CTA's channels only, the
last rank's part dropped from the cluster's sums of dB and dC, the tile
before fetched from the current tile, the tile before's first rows
fetched over this tile's instead of into the spare block, the channel
sums of dB and dC without their last shuffle round, and sub-tile 0
started from the state of sub-tile 1 (the tile's entering state not
fetched again). Phase 21 (the SSD's) or 23 (the selective scan's) of
``chip_smoke.py`` must pass with
the sound libraries and fail with each; each SSD fault only through the
cases of its kernel's route (``SSD_BWD_FAULT_KERNELS``), whose names it
prints.

For the sound top-k kernel and each of its faults it runs phase 2 of
``chip_smoke.py`` (the 105-case matrix and the edge cases, indices exact,
values bitwise) and prints whether it failed.

For the sound attention kernel and for each of its faults it prints one
JSON line:

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

For the two scan kernels, sound and faulty, it prints the tight check of
``chip_smoke.py`` (phases 8-9 and 12-13): the relative L2 distance of the
bf16 output from the f32 scan of the same bf16 inputs, at the prefill
shape (phase 8's and phase 12's cases there, with fast and slow decay)
and on the first call of a full-width prefill (zamba2-1.2b's SSD,
falcon-mamba-7b's selective scan), against ``SSD_BF16_REL_L2`` (the
SSD's slow-decay case against ``SSD_BF16_REL_L2_SLOW``) and
``SCAN_BF16_REL_L2``.

``ASYNC_FAULTS`` replace one function of the port's async engines for
the time of one phase: the flush's top-k with equal arrival times taken
highest index first, the snapshot ring's lookup one version off, and the
damping with its exponent dropped. ``SHARD_FAULTS`` do the same to the
sharded engines: the per-shard top-k leg with ``index_offset`` dropped,
the candidate merge with ties highest index first, and the
one-owner-per-slot gather summing two owners; ``ASYNC_SHARD_FAULTS`` to
the sharded async engine: the flush's cross-shard merge taking the
shards in reversed order, and the completers' start versions read from
the first shard without the one-owner gather. The sound engines must
pass phases 6e (async selection at 1,048,576 clients), 6f (plain, the
fused engine against the host loop at full width), 6k (sharded selection
at 1,048,576 clients on 1, 2 and 8 shards) and 6n (sharded async
selection at 1,048,576 clients on 1, 2 and 8 shards) of
``chip_smoke.py``, and each fault must fail the phase it names: the
reversed merge on ``completed``, the local start versions on
``staleness``.

Exits 1 unless each sound kernel and engine passes its check (bitwise for
top-k, the tight check for the others) and every fault fails it. The last
line is one JSON object with all the readings.
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

# name: (text in the kernel, its replacement); each text occurs once
_RESCALE = ("        oacc[4 * j] *= corr0;\n"
            "        oacc[4 * j + 1] *= corr0;\n"
            "        oacc[4 * j + 2] *= corr1;\n"
            "        oacc[4 * j + 3] *= corr1;\n")
FAULTS = {
    "output_scaled_1.05": (
        "const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);",
        "const float d0 = 1.05f * fmaxf(l0, 1e-30f),\n"
        "                d1 = 1.05f * fmaxf(l1, 1e-30f);"),
    # the skipped tile's barriers are still waited for and released, so
    # the copies go on
    "first_k_tile_skipped": (
        "      mbar_wait(full_k(st), ph);\n",
        "      mbar_wait(full_k(st), ph);\n"
        "      if (kt == 0 && n_tiles > 1) {\n"
        "        mbar_wait(full_v(st), ph);\n"
        "        if (lane == 0) mbar_arrive(empty(st));\n"
        "        continue;\n"
        "      }\n"),
    "diagonal_masked": (
        "if (col >= S || (causal && col > row)) s[4 * j + e] = kNegInf;",
        "if (col >= S || (causal && col >= row)) s[4 * j + e] = kNegInf;"),
    "accumulator_not_rescaled": (_RESCALE, ""),
    "accumulator_in_bf16": (
        _RESCALE,
        "#pragma unroll\n        for (int e = 0; e < 4; ++e)\n"
        "          oacc[4 * j + e] = __bfloat162float(__float2bfloat16_rn(\n"
        "              oacc[4 * j + e] * (e < 2 ? corr0 : corr1)));\n"),
}
TOPK_FAULTS = {
    "ties_highest_index_first": (
        "constexpr uint32_t kTieFlip = 0xffffffffu;",
        "constexpr uint32_t kTieFlip = 0u;"),
    "last_radix_pass_skipped": (
        "for (int pass = 0; pass < 4; ++pass)",
        "for (int pass = 0; pass < 3; ++pass)"),
}
SSD_FAULTS = {
    "carried_state_dropped": (
        "for (int e = 0; e < 4; ++e) hr[i][e] *= decay;",
        "for (int e = 0; e < 4; ++e) hr[i][e] = 0.f;"),
    "chunk_decay_not_applied": (
        "const float decay = expf(lend);", "const float decay = 1.f;"),
    "output_scaled_1.05": (
        "__floats2bfloat162_rn(yacc[j][2 * half], yacc[j][2 * half + 1]);",
        "__floats2bfloat162_rn(1.05f * yacc[j][2 * half],\n"
        "                                    1.05f * yacc[j][2 * half + 1]);"),
    # the chunk computed from the stage the copies are filling for the
    # next chunk (on chunk 0, a stage nothing has written yet)
    "prefetched_chunk_from_stale_stage": (
        "const uint8_t* stage = dsm + st * L::STAGE;",
        "const uint8_t* stage = dsm + (st ^ 1) * L::STAGE;"),
    # the low bf16 half of a split f32 operand dropped: of the carried
    # state h in C h, and of w x in the state update; they show only with
    # slow decay (SSD_BF16_REL_L2_SLOW)
    "h_low_part_dropped": (
        "          mma(yacc[2 * np], ca[kk], lf[0], lf[1]);\n"
        "          mma(yacc[2 * np + 1], ca[kk], lf[2], lf[3]);\n", ""),
    "wx_low_part_dropped": ("          mma(hr[i], bt, wl[0], wl[1]);\n", ""),
}
SCAN_FAULTS = {
    "d_skip_dropped": (
        "*yk = from_f32<T>(sy[r][lc] + sd[r][lc]);",
        "*yk = from_f32<T>(sy[r][lc]);"),
    "state_reset_each_tile": (
        "    __syncthreads();  // the last tile's readers of the shared tiles "
        "are done",
        "#pragma unroll\n    for (int j = 0; j < SPL; ++j) h[j] = 0.f;\n"
        "    __syncthreads();"),
    "decay_without_dt": (
        "da = ex2(fmaf(v.x, a2hi[j], v.x * a2lo[j]));",
        "da = ex2(a2hi[j] + a2lo[j]);"),
    "state_in_bf16": (
        "h[j] = fmaf(da, h[j], v.y * bv[j]);",
        "h[j] = __bfloat162float(__float2bfloat16_rn(\n"
        "              fmaf(da, h[j], v.y * bv[j])));"),
    # the last tile's y is the one before it (not left unwritten, which
    # could read back a sound output from reused memory)
    "last_tile_skipped": (
        "    for (int r0 = 0; r0 < kT; r0 += kLanes) {",
        "    for (int r0 = 0;\n"
        "         r0 < (tile + 1 == n_tiles && n_tiles > 1 ? 0 : kT);\n"
        "         r0 += kLanes) {"),
    # the cheap decay's argument in base e: 2^(dt A) for exp(dt A)
    "decay_without_log2e": (
        "const double a2 = (double)aj * kLog2e;",
        "const double a2 = (double)aj;"),
}
# Faults of the training path's attention, each one or more edits of one
# library: (library, [(text, replacement), ...]); phase 17 of
# chip_smoke.py (the backward against its plain version, the forward's
# log-sum-exp against the plain one) must fail on each.
BWD_FAULTS = {
    # each KV head's dK keeps only its last query head's share
    "dk_without_group_sum": ("flash_attention_bwd", [(
        "      mbar_wait_bounded(full(st), ph);\n",
        "      mbar_wait_bounded(full(st), ph);\n"
        "      if (it % n_qt == 0) {\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < DQKP / 2; ++i) dka[i] = 0.f;\n"
        "      }\n")]),
    # the tensor-core forward's log-sum-exp left in base 2, its running
    # max's
    "lse_in_base_2": ("flash_attention", [(
        "      if (row0 < S) lrow[row0] = (m0 + log2f(d0)) * kLn2;\n"
        "      if (row1 < S) lrow[row1] = (m1 + log2f(d1)) * kLn2;\n",
        "      if (row0 < S) lrow[row0] = m0 + log2f(d0);\n"
        "      if (row1 < S) lrow[row1] = m1 + log2f(d1);\n")]),
    # the last, ragged key tile's rows past S read (K and V mapped as one
    # sequence of B * S rows: the next batch's first keys, zeros after the
    # last batch) and not masked
    "ragged_k_tile_not_masked": ("flash_attention_bwd", [
        ("k0 + key0 + 8 * hr < S ? rlim : 0);", "rlim);"),
        ("          tma_load(sk + c * T::kKVBox, &kmap, full_kv, c * kBox, kh, "
         "k0, b);\n",
         "          tma_load(sk + c * T::kKVBox, &kmap, full_kv, c * kBox, kh,\n"
         "                   b * S + k0, 0);\n"),
        ("          tma_load(sv + c * T::kKVBox, &vmap, full_kv, c * kBox, kh, "
         "k0, b);\n",
         "          tma_load(sv + c * T::kKVBox, &vmap, full_kv, c * kBox, kh,\n"
         "                   b * S + k0, 0);\n"),
        ("      !make_map(&km, encode, k, B, S, KH, DQK, T::kBK, ks) ||\n"
         "      !make_map(&vm, encode, v, B, S, KH, DV, T::kBK, vs) ||\n",
         "      !make_map(&km, encode, k, 1, B * S, KH, DQK, T::kBK, ks) ||\n"
         "      !make_map(&vm, encode, v, 1, B * S, KH, DV, T::kBK, vs) ||\n")]),
    # dS^T stored without the 128-byte swizzle that the descriptors of dK
    # and dQ read
    "ds_tile_unswizzled": ("flash_attention_bwd", [(
        "st_shared(dsb + key * 128 + ((j ^ (key & 7)) << 4) + 4 * c,",
        "st_shared(dsb + key * 128 + (j << 4) + 4 * c,")]),
}

# Faults of the attention kernels at the (q.k, v) width pairs that are not
# one 64-column box or equal, in the same form; phase 26 of chip_smoke.py
# (both kernels against their plain versions and by the tight checks at
# WIDTH_SHAPES) must fail on each
WIDTH_FAULTS = {
    # q.k columns 64-95 dropped at a q.k width of 96: Q K^T runs 4 of its
    # 6 k-steps
    "qk_columns_64_95_dropped": ("flash_attention", [(
        "      for (int kk = 0; kk < DQK / 16; ++kk) {",
        "      for (int kk = 0; kk < (DQK == 96 ? 4 : DQK / 16); ++kk) {")]),
    # v's width mistaken for the q.k width in the scale: Dv^-0.5
    "scale_of_v_width": ("flash_attention", [(
        "H / KH, scale * kLog2e, causal);",
        "H / KH, rsqrtf((float)DV) * kLog2e, causal);")]),
    # dV summed over dO's stage tiles laid out at the q.k width: where v
    # is narrower than q.k, every second stage's dV reads the dS^T tile
    "dv_from_do_at_qk_width": ("flash_attention_bwd", [(
        "        wgmma_rs<DVP>(dva, pa[kq], wg_desc(da + row, T::kQBox, 1024));",
        "        wgmma_rs<DVP>(dva, pa[kq], wg_desc(sdo + st * T::kQTile + row,\n"
        "                                           T::kQBox, 1024));")]),
}

# Faults of both attention kernels at deepseek-v2-236b's pair (192, 128),
# in the same form; phase 32 of chip_smoke.py (both kernels against their
# plain versions and by the tight checks at WIDE_SHAPES) must fail on each
WIDE_FAULTS = {
    # the third q.k box never read: Q K^T runs 8 of its 12 k-steps at a
    # q.k width of 192 (columns 128-191 dropped)
    "qk_third_box_dropped": ("flash_attention", [(
        "      for (int kk = 0; kk < DQK / 16; ++kk) {",
        "      for (int kk = 0; kk < (DQK == 192 ? 8 : DQK / 16); ++kk) {")]),
    # the backward's own design (flash_bwd_wgmma_wide): dK's third 64-column
    # box never accumulated (each warpgroup's part of it stays 0)
    "dk_third_box_dropped": ("flash_attention_bwd", [(
        "      for (int i = 0; i < 2; ++i)\n"
        "        wgmma_rs_n64(dk2, sa[i],",
        "      for (int i = 0; i < 0; ++i)\n"
        "        wgmma_rs_n64(dk2, sa[i],")]),
    # the two warpgroups' dV columns swapped: each stores its box at the
    # other's columns
    "dv_boxes_swapped": ("flash_attention_bwd", [(
        "bf16* dvr = dv + row * DV + 64 * wg + 2 * c;",
        "bf16* dvr = dv + row * DV + 64 * (1 - wg) + 2 * c;")]),
    # P^T and dS^T stored without the 128-byte swizzle that the descriptors
    # of dV, dK and dQ read
    "pt_ds_tiles_unswizzled": ("flash_attention_bwd", [(
        "key * 128 + (((4 * wg + j) ^ (key & 7)) << 4) + 4 * c;",
        "key * 128 + ((4 * wg + j) << 4) + 4 * c;")]),
}

# Faults of the scan backward kernels, in the same form; phase 21 of
# chip_smoke.py (the SSD's) or 23 (the selective scan's) must fail on each:
# the kernel against its plain version at the JAX package's tolerances,
# and each gradient by the tight check against the f32 backward
SCAN_BWD_FAULTS = {
    # K, the gradient carried back into the chunk before, not decayed
    # across the chunk boundary
    "ssd_chunk_decay_dropped": ("ssd_chunk_bwd", [(
        "          *p = fmaf(decay, *p, acc[i][j]);\n",
        "          *p = *p + acc[i][j];\n")]),
    # dA without its even steps' terms
    "ssd_da_term_dropped": ("ssd_chunk_bwd", [(
        "      da_acc = fmaf(sdt[s0], m0, fmaf(sdt[s1], m1, da_acc));",
        "      da_acc = fmaf(sdt[s1], m1, da_acc);")]),
    # dB summed over one CTA's head only
    "ssd_db_one_head": ("ssd_chunk_bwd", [(
        "          if (t < S) atomicAdd(dbb + (long long)t * DS + n, "
        "d * (acc[i][j] + kxv));",
        "          if (t < S && h == 0) atomicAdd(dbb + (long long)t * DS + "
        "n, d * (acc[i][j] + kxv));")]),
    # the bf16 route's carry pass: K not decayed across the chunk boundary
    "ssd_carry_decay_dropped": ("ssd_chunk_bwd", [(
        "      for (int e = 0; e < 4; ++e) acc[j][e] *= decay;\n",
        "      for (int e = 0; e < 4; ++e) acc[j][e] *= 1.f;\n")]),
    # the bf16 chunk-local kernel: dA without its even steps' terms
    "ssd_local_da_terms_dropped": ("ssd_chunk_bwd", [(
        "      const float da = warp_sum(fmaf(sdt[s0], mt0, sdt[s1] * mt1));",
        "      const float da = warp_sum(sdt[s1] * mt1);")]),
    # the bf16 chunk-local kernel: dB summed over the CTA's first head only
    "ssd_local_db_one_head": ("ssd_chunk_bwd", [(
        "    for (int j = 0; j < ND; ++j) {\n"
        "      float2* pa = reinterpret_cast<float2*>(sdb + ra",
        "    for (int j = 0; j < ND && hi == 0; ++j) {\n"
        "      float2* pa = reinterpret_cast<float2*>(sdb + ra")]),
    # the bf16 chunk-local kernel: Dm's low part dropped from Dm^T dy
    "ssd_local_dm_low_part_dropped": ("ssd_chunk_bwd", [(
        "        mma(z[2 * np], dl, f[0], f[1]);\n"
        "        mma(z[2 * np + 1], dl, f[2], f[3]);\n", "")]),
    # g carried into the tile before without the decay of the tile's first
    # step
    "scan_tile_decay_dropped": ("selective_scan_bwd", [(
        "              g[j] = ga;\n",
        "              g[j] = s == 0 && u == 0 ? g[j] : ga;\n")]),
    # dA's terms without the step's decay a
    "scan_da_term_dropped": ("selective_scan_bwd", [(
        "              dacc[j] = fmaf(dtv, m, dacc[j]);",
        "              dacc[j] = fmaf(dtv, g[j] * hp[u][j], dacc[j]);")]),
    # dB summed over the cluster's first CTA's 64 channels only
    "scan_db_one_cta": ("selective_scan_bwd", [(
        "      for (int r = 0; r < kCluster; ++r) {",
        "      for (int r = 0; r < (kind ? kCluster : 1); ++r) {")]),
    # the cluster's last rank's part of dB and dC dropped
    "scan_rank_part_dropped": ("selective_scan_bwd", [(
        "      for (int r = 0; r < kCluster; ++r) {",
        "      for (int r = 0; r + 1 < kCluster; ++r) {")]),
    # the tile before's rows fetched from the current tile
    "scan_prefetch_current_tile": ("selective_scan_bwd", [(
        "      refill(rb / kSub, t0 - kT, s * kSub, true, tile > 0 && s > 0,",
        "      refill(rb / kSub, t0, s * kSub, true, tile > 0 && s > 0,")]),
    # the tile before's first rows fetched into this tile's block, not the
    # spare one
    "scan_spare_block_unused": ("selective_scan_bwd", [(
        "    if (tile > 0) refill(kNSub - blk0, t0 - kT, 0, false, true, 0);",
        "    if (tile > 0) refill(blk0, t0 - kT, 0, false, true, 0);")]),
    # the channel sums of dB and dC without their last shuffle round (over
    # 4 of the warp's 8 channels)
    "scan_channel_round_dropped": ("selective_scan_bwd", [(
        "    for (int half = 4; half >= 1; half /= 2) {",
        "    for (int half = 4; half >= 2; half /= 2) {")]),
    # sub-tile 0 started from sub-tile 1's state: the tile's entering state
    # not fetched into the slot again
    "scan_sub0_state_stale": ("selective_scan_bwd", [(
        "      if (s == 1) fetch_state(0, tile);\n", "")]),
}
# the phase of chip_smoke.py that holds each scan backward library
SCAN_BWD_PHASES = {"ssd_chunk_bwd": "phase_ssd_bwd_vs_plain",
                   "selective_scan_bwd": "phase_scan_bwd_vs_plain"}
# the kernel each SSD backward fault edits, and the route whose cases of
# phase 21 it must fail (the other route's cases pass): the scalar
# kernel's are the f32 route's, the carry pass's and the chunk-local
# kernel's the bf16 route's
SSD_BWD_FAULT_KERNELS = {
    "ssd_chunk_decay_dropped": ("ssd_bwd(", "float32"),
    "ssd_da_term_dropped": ("ssd_bwd(", "float32"),
    "ssd_db_one_head": ("ssd_bwd(", "float32"),
    "ssd_carry_decay_dropped": ("ssd_bwd_carry(", "bfloat16"),
    "ssd_local_da_terms_dropped": ("ssd_bwd_local(", "bfloat16"),
    "ssd_local_db_one_head": ("ssd_bwd_local(", "bfloat16"),
    "ssd_local_dm_low_part_dropped": ("ssd_bwd_local(", "bfloat16")}


# library: (its faults, the kernel function they edit)
def _ties_reversed(sound):
    """The flush's ``_top_k_idx`` with equal values highest index first."""
    def top_k(x, k):
        n = x.shape[0]
        return n - 1 - sound(x.flip(0), k)
    return top_k


def _lookup_one_off(sound):
    """The ring lookup of the version before the requested one."""
    return lambda ring, versions: sound(ring, versions - 1)


def _damping_dropped(sound):
    """``(1 + s) ** -power`` with the exponent dropped: every weight 1."""
    return lambda staleness, power: sound(staleness, 0.0)


# name: (module of the port, the name it is read by there, the fault made
# from the sound function, the phase of chip_smoke.py whose check must
# fail)
ASYNC_FAULTS = {
    "flush_ties_highest_index_first": (
        "repro_torch.federated.simulation", "_top_k_idx", _ties_reversed,
        "6e"),
    "ring_lookup_one_version_off": (
        "repro_torch.federated.async_server", "_ring_lookup",
        _lookup_one_off, "6f"),
    "damping_exponent_dropped": (
        "repro_torch.federated.simulation", "staleness_damping",
        _damping_dropped, "6e"),
}


def _offset_dropped(sound):
    """The top-k wrapper with ``index_offset`` ignored: each shard's
    candidates keep their local indices."""
    def topk_reward(a, b, valid, *, index_offset=0, **kw):
        return sound(a, b, valid, **kw)
    return topk_reward


def _merge_ties_reversed(sound):
    """The candidate merge with the gathered candidates reversed, so that
    equal values go highest index first."""
    return lambda v_loc, i_loc, k, axis: sound(v_loc.flip((0, 1)),
                                               i_loc.flip((0, 1)), k, axis)


def _two_owners(sound):
    """The slot owner with each shard also claiming the next shard's
    slots, so that every one-owner-per-slot gather sums two owners."""
    def slot_owner(idx, base, n_loc):
        own, loc = sound(idx, base, n_loc)
        return own | sound(idx, base + n_loc, n_loc)[0], loc
    return slot_owner


def _merge_shards_reversed(sound):
    """The async flush's cross-shard merge with the shards' candidates
    gathered in reversed shard order (each keeps its own indices), so that
    equal arrival times go highest shard first."""
    return lambda g_loc, k, k_loc, base, axis: sound(g_loc.flip(0), k, k_loc,
                                                     base.flip(0), axis)


def _start_version_read_locally(sound):
    """The async flush's int32 gather (the completers' start versions)
    read from this process's first shard at the slot's clamped local
    position, with no owner and no sum over the mesh."""
    def slot_gather(x, idx, mask, axis=None, **kw):
        import torch
        if axis is None or kw.get("dtype") is not torch.int32:
            return sound(x, idx, mask, axis, **kw)
        n_loc = x.shape[-1]
        loc = torch.clamp(idx, 0, n_loc - 1)
        return torch.where(mask, x[0].gather(0, loc), torch.zeros_like(loc)
                           ).to(torch.int32)
    return slot_gather


# the sharded engines' planted faults, in the same form; a name imported
# by several modules is replaced in each
SHARD_FAULTS = {
    "per_shard_leg_index_offset_dropped": (
        ("repro_torch.kernels.ops",), "topk_reward", _offset_dropped,
        "6k"),
    "merge_ties_highest_index_first": (
        ("repro_torch.core.selection",), "_merge_candidates",
        _merge_ties_reversed, "6k"),
    "slot_gather_two_owners": (
        ("repro_torch.core.selection", "repro_torch.federated.simulation",
         "repro_torch.federated.server"), "_slot_owner", _two_owners,
        "6k"),
}
# the sharded async engine's, in the same form, with the column the first
# failure must name
ASYNC_SHARD_FAULTS = {
    "async_flush_merge_shards_reversed": (
        ("repro_torch.federated.simulation",), "_merge_topk",
        _merge_shards_reversed, "6n", "completed"),
    "async_start_version_read_locally": (
        ("repro_torch.federated.simulation",), "_slot_gather",
        _start_version_read_locally, "6n", "staleness"),
}


def async_phase(torch, ops, ref, dev, phase):
    """Run phase 6e, 6f (plain only), 6k or 6n of ``chip_smoke.py``;
    returns ``{"fails": bool, "first_failure": text}``."""
    try:
        if phase == "6e":
            cs.phase_async_selection(torch, ops, ref, dev, 1_048_576, 4)
        elif phase == "6k":
            cs.phase_sharded_selection(torch, ops, ref, dev, 1_048_576, 3)
        elif phase == "6n":
            cs.phase_async_sharded_selection(torch, ops, ref, dev,
                                             1_048_576, 4)
        else:
            cs.phase_async_parity(
                torch, ops, ref, dev,
                cs.fl_config(200, 10, 6, buffer_size=4, max_concurrency=10,
                             staleness_power=cs.ASYNC_POWER),
                budget=False, restart=False)
    except AssertionError as err:     # a SmokeFailure or a tolerance
        return {"fails": True, "first_failure": str(err)[:300]}
    return {"fails": False}


def async_readings(torch, ops, ref, dev):
    """The sound engines on phases 6e, 6f, 6k and 6n, then each planted
    fault of the async and the sharded engines on the phase it names (a
    fault of the sharded async engine must fail on the column
    ``ASYNC_SHARD_FAULTS`` gives)."""
    import importlib
    out = {"sound": {ph: async_phase(torch, ops, ref, dev, ph)
                     for ph in ("6e", "6f", "6k", "6n")}}
    faults = {name: ((module,), attr, make, phase) for name, (
        module, attr, make, phase) in ASYNC_FAULTS.items()}
    faults.update(SHARD_FAULTS)
    faults.update({name: spec[:4] for name, spec in
                   ASYNC_SHARD_FAULTS.items()})
    for name, (modules, attr, make_fault, phase) in faults.items():
        mods = [importlib.import_module(m) for m in modules]
        sound = getattr(mods[0], attr)
        for mod in mods:
            setattr(mod, attr, make_fault(sound))
        try:
            out[name] = {phase: async_phase(torch, ops, ref, dev, phase)}
            if name in ASYNC_SHARD_FAULTS:
                reading = out[name][phase]
                reading["fails"] = reading["fails"] and \
                    ASYNC_SHARD_FAULTS[name][4] in reading["first_failure"]
        finally:
            for mod in mods:
                setattr(mod, attr, sound)
        cs.log(json.dumps({"engines": {name: out[name]}}))
    return out


KERNEL_FAULTS = {"topk_select": (TOPK_FAULTS, "topk_select("),
                 "flash_attention": (FAULTS, "flash_fwd_wgmma("),
                 "ssd_chunk": (SSD_FAULTS, "ssd_fwd_mma("),
                 "selective_scan": (SCAN_FAULTS, "scan_fwd(")}


def build_fault(ops, lib, name, old, new, tmp):
    """Compile library ``lib`` with one fault planted: ``old`` replaced by
    ``new``, or, with ``new`` None, each ``(text, replacement)`` pair of
    the list ``old``; returns its path."""
    src = (ops.CSRC / f"{lib}.cu").read_text()
    for text, repl in ([(old, new)] if new is not None else old):
        cs.check(src.count(text) == 1, f"fault {name}: its text occurs "
                 f"{src.count(text)} times in {lib}.cu, not once")
        src = src.replace(text, repl)
    cu = Path(tmp) / f"{lib}-{name}.cu"
    cu.write_text(src)
    out = Path(tmp) / f"lib{lib}-{name}.so"
    proc = subprocess.run([ops._nvcc(), *ops.nvcc_flags(lib), "-I",
                           str(ops.CSRC), "-o", str(out), str(cu)],
                          capture_output=True, text=True)
    cs.check(proc.returncode == 0, f"nvcc failed for fault {name}:\n"
             f"{proc.stderr}")
    return out


def logit_rel_l2(torch, got, exact):
    """Phase 9's and 10's relative L2 reading of two logit tensors; NaN
    where ``got`` holds a non-finite value (which chip_smoke.py fails
    outright)."""
    try:
        return cs.logit_diff(torch, got, exact, "")["rel_l2"]
    except cs.SmokeFailure:
        return float("nan")


def fails(tight, limits):
    """A tight check's readings fail it (a NaN fails); ``limits`` maps
    each reading's name to its limit."""
    return not all(v <= limits[where] for where, v in tight.items())


def build_all(ops, tmp):
    """The sound libraries and every fault, one nvcc each, all at once;
    returns ``{lib: {"sound" or fault name: bound library}}`` and
    ``{fault name: (library, bound library)}`` of ``BWD_FAULTS``,
    ``WIDTH_FAULTS``, ``WIDE_FAULTS`` and ``SCAN_BWD_FAULTS``."""
    jobs = sum(len(faults) + 1 for faults, _ in KERNEL_FAULTS.values()) \
        + len(BWD_FAULTS) + len(WIDTH_FAULTS) + len(WIDE_FAULTS) \
        + len(SCAN_BWD_FAULTS) + 1 \
        + len(SCAN_BWD_PHASES)
    with ThreadPoolExecutor(jobs) as pool:
        sound = {lib: pool.submit(ops.build_library, lib)
                 for lib in (*KERNEL_FAULTS, "flash_attention_bwd",
                             *SCAN_BWD_PHASES)}
        built = {lib: {n: pool.submit(build_fault, ops, lib, n, o, w, tmp)
                       for n, (o, w) in faults.items()}
                 for lib, (faults, _) in KERNEL_FAULTS.items()}
        bwd_built = {n: (lib, pool.submit(build_fault, ops, lib, n, edits,
                                          None, tmp))
                     for n, (lib, edits) in {**BWD_FAULTS, **WIDTH_FAULTS,
                                             **WIDE_FAULTS,
                                             **SCAN_BWD_FAULTS}.items()}
        libs = {}
        for lib in KERNEL_FAULTS:
            sound[lib].result()
            libs[lib] = {"sound": ops.load_library(lib)}
            libs[lib].update({n: ops._BINDERS[lib](ctypes.CDLL(str(
                f.result()))) for n, f in built[lib].items()})
        for lib in ("flash_attention_bwd", *SCAN_BWD_PHASES):
            sound[lib].result()
            ops.load_library(lib)
        bwd = {n: (lib, ops._BINDERS[lib](ctypes.CDLL(str(f.result()))))
               for n, (lib, f) in bwd_built.items()}
    return libs, bwd


def bwd_readings(torch, ops, ref, dev, faulty, phase=None,
                 label="flash_attention_bwd"):
    """Phase 17 of chip_smoke.py (or the phase function ``phase``) with the
    sound libraries and with each fault of ``faulty`` (``BWD_FAULTS``, or
    ``WIDTH_FAULTS`` for phase 26) swapped in: ``{name: {"fails",
    "first_failure"}}``."""
    phase = phase or cs.phase_attn_bwd_vs_plain
    out = {}
    for name, (lib, bound) in [("sound", (None, None)), *faulty.items()]:
        sound = ops._LIBS.get(lib)
        if lib is not None:
            ops._LIBS[lib] = bound
        try:
            phase(torch, ops, ref, dev)
            out[name] = {"fails": False}
        except cs.SmokeFailure as err:
            out[name] = {"fails": True, "first_failure": str(err)[:300]}
        finally:
            if lib is not None:
                ops._LIBS[lib] = sound
        torch.cuda.empty_cache()
        cs.log(json.dumps({label: {name: out[name]}}))
    return out


# the backward's tight check alone at (192, 128) (phase 32 fails the
# faults on its elementwise check first): B, S, H, KH, Dqk, Dv, bf16,
# causal and not
WIDE_TIGHT_SHAPES = [(1, 32, 4, 4, 192, 128), (2, 333, 8, 4, 192, 128)]


def wide_tight_readings(torch, ops, ref, dev, faulty):
    """The tight check of the backward at (192, 128) (chip_smoke.py's
    ``bwd_rel_l2``: each gradient's relative L2 from the f32 backward of
    the same inputs) on ``WIDE_TIGHT_SHAPES`` with the sound library and
    with each backward fault of ``faulty`` (``WIDE_FAULTS``): ``{name:
    {"tight": {case: readings}, "tight_fails"}}``, failing above
    ``ATTN_BWD_BF16_REL_L2`` (a NaN fails)."""
    from repro_torch.kernels import flash_attention as fa

    fwd = ops.load_library("flash_attention")
    out = {}
    for name, (lib, bound) in [("sound", (None, None)), *faulty.items()]:
        if lib not in (None, "flash_attention_bwd"):
            continue
        bwd = bound or ops.load_library("flash_attention_bwd")
        tight = {}
        for i, (B, S, H, KH, D, Dv) in enumerate(WIDE_TIGHT_SHAPES):
            q, k, v, do = cs.attn_bwd_inputs(torch, B, S, H, KH, D,
                                             torch.bfloat16, dev, 700 + i,
                                             dv=Dv)
            for causal in (True, False):
                o, lse = fa.launch(fwd, q, k, v, causal=causal,
                                   with_lse=True)
                grads = fa.launch_bwd(bwd, q, k, v, o, lse, do,
                                      causal=causal)
                tight[f"{B}x{S}x{H}x{KH} causal={causal}"] = cs.bwd_rel_l2(
                    torch, ref, grads, q, k, v, o, lse, do, causal)
        out[name] = {"tight": tight, "tight_fails": not all(
            x <= cs.ATTN_BWD_BF16_REL_L2 for r in tight.values()
            for x in r.values())}
        cs.log(json.dumps({"attention_192_tight": {name: out[name]}}))
    return out


def scan_bwd_readings(torch, ops, ref, dev, faulty):
    """Phases 21 and 23 of chip_smoke.py with the sound libraries (both
    phases) and with each of ``SCAN_BWD_FAULTS`` swapped in (the phase of
    its library): ``{name: {"fails", "first_failure"}}``, and for the SSD's
    faults the cases of phase 21 that failed and whether they were all
    the fault's route's (``SSD_BWD_FAULT_KERNELS``)."""
    out = {}
    runs = [("sound", None, None)] + [(n, lib, bound) for n, (lib, bound)
                                      in faulty.items()]
    for name, lib, bound in runs:
        sound = ops._LIBS.get(lib)
        if lib is not None:
            ops._LIBS[lib] = bound
        try:
            for phase_lib, phase in SCAN_BWD_PHASES.items():
                if lib in (None, phase_lib):
                    getattr(cs, phase)(torch, ops, ref, dev)
            out[name] = {"fails": False}
        except cs.SmokeFailure as err:
            out[name] = {"fails": True, "first_failure": str(err)[:300]}
            cases = sorted(getattr(err, "cases", {}))
            if name in SSD_BWD_FAULT_KERNELS:
                route = SSD_BWD_FAULT_KERNELS[name][1]
                out[name].update(failed_cases=cases, route=route,
                                 fails_through_its_route=bool(cases) and all(
                                     c.endswith(route) for c in cases))
        finally:
            if lib is not None:
                ops._LIBS[lib] = sound
        torch.cuda.empty_cache()
        cs.log(json.dumps({"scan_bwd": {name: out[name]}}))
    return out


def scan_readings(torch, libs, launch, inputs, limits, label):
    """The tight check of each library on each named input set; ``inputs``
    maps a name to (args, the f32 scan of them), ``limits`` a name to its
    limit."""
    readings = {}
    for name, lib in libs.items():
        tight = {where: cs.rel_l2(torch, launch(lib, *args), exact)
                 for where, (args, exact) in inputs.items()}
        readings[name] = {"tight": tight,
                          "tight_fails": fails(tight, limits)}
        cs.log(json.dumps({label: {name: readings[name]}}))
    return readings


def prefill_tokens(torch, cfg, seed, dev):
    """The tokens of chip_smoke.py's prefill (phases 9 and 13)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return {"tokens": torch.randint(
        0, cfg.vocab_size, (cs.PREFILL_BATCH, cs.PREFILL_LEN),
        generator=g).to(dev)}


def ssd_cases(torch, ref, dev, prefill_call):
    """Phase 8's bf16 cases at the prefill shape (dt about 0.7 and about
    0.02) and the zamba2 prefill's first SSD call, each with the f32 scan
    of its inputs: ``{name: (args, exact)}``."""
    cases = {}
    for where, args in [
            (f"prefill_shape dt shift {c[-1]}",
             cs.ssd_inputs(torch, *c[:5], torch.bfloat16, dev, 100 + i,
                           c[-1]))
            for i, c in enumerate(cs.SSD_SHAPES) if c[:2] == (2, 4096)] + [
            ("prefill_call", prefill_call)]:
        x, Bm, Cm, dt, A = args
        cases[where] = (args, ref.ssd_chunk(x.float(), Bm.float(),
                                            Cm.float(), dt, A))
    return cases


def ssd_limits(inputs):
    """The tight check's limit for each of :func:`ssd_cases`' inputs:
    ``SSD_BF16_REL_L2_SLOW`` for the slow-decay case."""
    return {where: cs.ssd_limit(cs.SLOW_DT_SHIFT)
            if where == f"prefill_shape dt shift {cs.SLOW_DT_SHIFT}"
            else cs.SSD_BF16_REL_L2 for where in inputs}


def scan_cases(torch, ref, dev, prefill_call):
    """Phase 12's bf16 cases at the prefill shape (dt about 0.7 and about
    0.02) and falcon-mamba-7b's first scan call, each with the f32 scan of
    its inputs: ``{name: (args, exact)}``."""
    cases = {}
    for where, args in [
            (f"prefill_shape dt shift {c[-1]}",
             cs.scan_inputs(torch, *c[:4], torch.bfloat16, dev, 200 + i,
                            c[-1]))
            for i, c in enumerate(cs.SCAN_SHAPES)
            if c[:4] == (2, 4096, 8192, 16)] + [
            ("prefill_call", prefill_call)]:
        cases[where] = (args, ref.selective_scan(*(t.float() for t in args)))
    return cases


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
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import forward_logits, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    cs.log(f"card {smi.stdout.strip()}")
    bf16 = torch.bfloat16

    with tempfile.TemporaryDirectory() as tmp:
        all_libs, bwd_libs = build_all(ops, tmp)

    # top-k: phase 2 of chip_smoke.py (the 105-case matrix and the edge
    # cases, indices exact and values bitwise) on each library
    topk = {}
    for name, lib in all_libs["topk_select"].items():
        ops._LIBS["topk_select"] = lib
        try:
            cs.phase_kernel_vs_plain(torch, ops, ref, dev, cs.TOPK_SIZES)
            topk[name] = {"bitwise_fails": False}
        except cs.SmokeFailure as err:
            topk[name] = {"bitwise_fails": True,
                          "first_failure": str(err)[:300]}
        cs.log(json.dumps({"topk_reward": {name: topk[name]}}))
    ops._LIBS["topk_select"] = all_libs["topk_select"]["sound"]
    libs = all_libs["flash_attention"]

    # inputs: phase 7's at the prefill shape, the prefill's first call
    synth = cs.attn_inputs(torch, 2, 4096, 32, 32, 64, bf16, dev, 1)
    cfg = get_config("zamba2-1.2b")
    params = init_params(seed, cfg, device=dev)
    batch = prefill_tokens(torch, cfg, seed, dev)
    with cs.first_calls(ops, ("flash_attention", "ssd_chunk")) as seen:
        forward_logits(cfg, params, batch, device=dev)
    call = seen["flash_attention"][0]
    cfg32 = cfg.with_(compute_dtype=torch.float32)
    exact = forward_logits(cfg32, params, batch, device=dev,
                           use_kernel=False)
    plain = forward_logits(cfg, params, batch, device=dev, use_kernel=False)
    plain_d = cs.logit_diff(torch, plain, exact, "plain")["rel_l2"]
    del plain
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (4, 32), generator=g).to(dev)
    replay = generate(cfg, params, prompt, 16, device=dev).prompt_logits

    attn = {}
    for name, lib in libs.items():
        ops._LIBS["flash_attention"] = lib
        tight = {"prefill_shape": cs.attn_rel_l2(
                     torch, ref, fa.launch(lib, *synth), *synth, True),
                 "prefill_call": cs.attn_rel_l2(
                     torch, ref, fa.launch(lib, *call), *call, True)}
        logits = forward_logits(cfg, params, batch, device=dev)
        route = logit_rel_l2(torch, logits, exact)
        del logits
        fwd = forward_logits(cfg, params, {"tokens": prompt}, device=dev)
        r = {"tight": tight,
             "tight_fails": fails(tight, dict.fromkeys(
                 tight, cs.ATTN_BF16_REL_L2)),
             "route_ratio": route / plain_d,
             "route_fails": not route / plain_d <= cs.BF16_ROUTE_RATIO,
             # as phase 10 reads it
             "replay_rel_l2": logit_rel_l2(torch, replay, fwd[:, -1:])}
        r["replay_fails"] = not r["replay_rel_l2"] <= cs.BF16_REPLAY_REL_L2
        attn[name] = r
        cs.log(json.dumps({"flash_attention": {name: r}}))
    ops._LIBS["flash_attention"] = libs["sound"]
    del params, exact, replay, synth, call

    # SSD: phase 8's cases at the prefill shape (dt about 0.7 and about
    # 0.02) and the zamba2 prefill's first SSD call
    ssd_in = ssd_cases(torch, ref, dev, seen["ssd_chunk"][0])
    del seen
    ssd = scan_readings(torch, all_libs["ssd_chunk"], sc.launch, ssd_in,
                        ssd_limits(ssd_in), "ssd_chunk")
    del ssd_in
    torch.cuda.empty_cache()

    # selective scan: phase 12's cases at the prefill shape and
    # falcon-mamba-7b's first call
    cfg = get_config("falcon-mamba-7b")
    params = init_params(seed, cfg, device=dev)
    with cs.first_calls(ops, ("selective_scan",)) as seen:
        forward_logits(cfg, params, prefill_tokens(torch, cfg, seed, dev),
                       device=dev)
    del params
    torch.cuda.empty_cache()
    scan_in = scan_cases(torch, ref, dev, seen["selective_scan"][0])
    del seen
    scan = scan_readings(torch, all_libs["selective_scan"], ss.launch,
                         scan_in, dict.fromkeys(scan_in, cs.SCAN_BF16_REL_L2),
                         "selective_scan")
    del scan_in, all_libs, libs

    # the training path's attention: the sound libraries pass phase 17,
    # each fault fails it
    bwd = bwd_readings(torch, ops, ref, dev, {
        n: v for n, v in bwd_libs.items() if n in BWD_FAULTS})
    # the attention kernels at their width pairs: the sound libraries pass
    # phase 26, each fault fails it
    widths = bwd_readings(torch, ops, ref, dev, {
        n: v for n, v in bwd_libs.items() if n in WIDTH_FAULTS},
        cs.phase_attn_widths_vs_plain, "attention_widths")
    # both kernels at (192, 128): the sound libraries pass phase 32, each
    # fault fails it
    wide = bwd_readings(torch, ops, ref, dev, {
        n: v for n, v in bwd_libs.items() if n in WIDE_FAULTS},
        cs.phase_attn_wide_vs_plain, "attention_192")
    # and the backward's faults by its tight check alone
    wide_tight = wide_tight_readings(torch, ops, ref, dev, {
        n: v for n, v in bwd_libs.items() if n in WIDE_FAULTS})
    # the scans' backward: the sound libraries pass phases 21 and 23, each
    # fault fails its library's phase
    scan_bwd = scan_bwd_readings(torch, ops, ref, dev, {
        n: v for n, v in bwd_libs.items() if n in SCAN_BWD_FAULTS})
    del bwd_libs

    # the async and sharded engines: the sound ones pass phases 6e, 6f, 6k
    # and 6n, each fault fails the phase it names
    asyn = async_readings(torch, ops, ref, dev)

    readings = {"topk_reward": topk, "flash_attention": attn,
                "ssd_chunk": ssd, "selective_scan": scan,
                "flash_attention_bwd": bwd, "attention_widths": widths,
                "attention_192": wide, "attention_192_tight": wide_tight,
                "scan_bwd": scan_bwd, "async": asyn}
    limits = {"topk_reward": {"bitwise": "indices exact, values bitwise"},
              "flash_attention": {"tight": cs.ATTN_BF16_REL_L2,
                                  "route_ratio": cs.BF16_ROUTE_RATIO,
                                  "replay_rel_l2": cs.BF16_REPLAY_REL_L2},
              "ssd_chunk": {"tight": cs.SSD_BF16_REL_L2,
                            "tight_slow_decay": cs.SSD_BF16_REL_L2_SLOW},
              "selective_scan": {"tight": cs.SCAN_BF16_REL_L2},
              "flash_attention_bwd": {
                  "17": "the backward against its plain version (tolerance "
                        + json.dumps(cs.ATTN_TOL) + ", bf16 also the tight "
                        f"check at {cs.ATTN_BWD_BF16_REL_L2}) and both "
                        "forward designs' log-sum-exp against the plain "
                        "one"},
              "attention_widths": {
                  "26": "both kernels at the (q.k, v) pairs of WIDTH_SHAPES "
                        "against their plain versions (tolerance "
                        + json.dumps(cs.ATTN_TOL) + ") and by the tight "
                        f"checks ({cs.ATTN_BF16_REL_L2} forward, "
                        f"{cs.ATTN_BWD_BF16_REL_L2} backward)"},
              "attention_192": {
                  "32": "both kernels at (192, 128) on WIDE_SHAPES against "
                        "their plain versions (tolerance "
                        + json.dumps(cs.ATTN_TOL) + ") and by the tight "
                        f"checks ({cs.ATTN_BF16_REL_L2} forward, "
                        f"{cs.ATTN_BWD_BF16_REL_L2} backward)"},
              "attention_192_tight": {"tight": cs.ATTN_BWD_BF16_REL_L2},
              "scan_bwd": {
                  "21": "the SSD backward against its plain version "
                        "(tolerance " + json.dumps(cs.SSD_TOL) + "; bf16 "
                        "also its carry pass), every case run; each SSD "
                        "fault must fail only its route's cases: "
                        + json.dumps({k: v[1] for k, v in
                                      SSD_BWD_FAULT_KERNELS.items()}),
                  "23": "the selective-scan backward against its plain "
                        "version (tolerance " + json.dumps(cs.SCAN_TOL) + ")",
                  "tight": {"bf16": cs.SCAN_BWD_BF16_REL_L2,
                            "f32": cs.SCAN_BWD_F32_REL_L2}},
              "async": {"6e": "flush, staleness and damping against the "
                              "event clock recomputed on the host",
                        "6f": "fused engine against the host loop",
                        "6k": "sharded selection on 1, 2 and 8 shards "
                              "against the single-device engine, every "
                              "launch against the plain version",
                        "6n": "sharded async selection on 1, 2 and 8 "
                              "shards against the single-device engine "
                              "and an all-ties aggregation; the faults "
                              "must fail on " + json.dumps(
                                  {k: v[4] for k, v in
                                   ASYNC_SHARD_FAULTS.items()})}}
    fail_key = {"topk_reward": "bitwise_fails",
                "flash_attention_bwd": "fails", "attention_widths": "fails",
                "attention_192": "fails",
                "scan_bwd": "fails"}
    ok = all(not r["sound"][fail_key.get(k, "tight_fails")] and all(
        v[fail_key.get(k, "tight_fails")] for n, v in r.items()
        if n != "sound") for k, r in readings.items() if k != "async")
    ok = ok and all(scan_bwd[n].get("fails_through_its_route", False)
                    for n in SSD_BWD_FAULT_KERNELS)
    ok = ok and not any(v["fails"] for v in asyn["sound"].values()) and all(
        v["fails"] for n, r in asyn.items() if n != "sound"
        for v in r.values())
    cs.log(json.dumps({"ok": ok, "limits": limits, "readings": readings}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
