"""Config schema for the LM architectures and their input shapes.

The port's copy of ``repro/configs/base.py`` with torch dtypes
(``param_dtype=torch.float32`` master weights, ``compute_dtype=
torch.bfloat16``). ``HardwareSpec`` keeps the reference's fields
(``peak_flops``, ``hbm_bw``, ``ici_bw``) and has no defaults: its one
instance, :data:`H100_SXM`, describes the card the port runs on, in place
of the reference's ``TPU_V5E``. ``MeshConfig`` and the pod meshes have no
counterpart yet: the dry-run runs on the one-device host mesh.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict

import torch


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. Covers dense / moe / ssm / hybrid / vlm / audio."""

    name: str
    arch_type: str                   # dense | moe | ssm | hybrid | vlm | audio
    source: str                      # citation (arXiv id / model card)
    n_layers: int
    d_model: int
    vocab_size: int

    # ---- attention ----
    attn_kind: str = "gqa"           # gqa | mla | none
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0

    # ---- MLA (DeepSeek-V2 / MiniCPM3) ----
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # ---- FFN ----
    d_ff: int = 0
    act: str = "swiglu"              # swiglu | gelu

    # ---- MoE ----
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    first_k_dense: int = 0           # leading dense layers (DeepSeek-V2: 1)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # ---- SSM ----
    ssm_variant: str = ""            # mamba1 | mamba2
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64           # mamba2 (SSD) head dim
    dt_rank: int = 0                 # mamba1; 0 -> ceil(d_model/16)

    # ---- hybrid (Zamba2) ----
    attn_every: int = 0              # shared attention block applied every k layers

    # ---- norm / residual ----
    norm: str = "rmsnorm"            # rmsnorm | np_layernorm (OLMo non-parametric)

    # ---- modality frontends ----
    frontend: str = ""               # "" | vision | audio
    n_codebooks: int = 1             # musicgen EnCodec codebooks
    n_patches: int = 0               # vision patch embeddings prepended

    tie_embeddings: bool = True
    param_dtype: Any = torch.float32     # master weights
    compute_dtype: Any = torch.bfloat16

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def ssm_n_heads(self) -> int:
        """Mamba2 SSD heads."""
        return self.d_inner // self.ssm_head_dim

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # ---- analytic parameter counts ----
    def param_count(self, active_only: bool = False) -> int:
        D = self.d_model
        n = 0
        # embeddings (+ untied head)
        n += self.vocab_size * D * self.n_codebooks
        if not self.tie_embeddings:
            n += self.vocab_size * D * self.n_codebooks
        for layer in range(self.n_layers):
            n += self._layer_params(layer, active_only)
        if self.attn_every:  # zamba2 shared attention+mlp block
            hd = self.resolved_head_dim
            n += D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd + self.n_heads * hd * D
            n += 3 * D * self.d_ff
        return n

    def _layer_params(self, layer: int, active_only: bool) -> int:
        D = self.d_model
        n = 0
        if self.arch_type in ("ssm", "hybrid"):
            di, ds = self.d_inner, self.ssm_state
            if self.ssm_variant == "mamba1":
                dtr = self.resolved_dt_rank
                n += D * 2 * di                      # in_proj
                n += di * self.ssm_conv              # conv
                n += di * (dtr + 2 * ds)             # x_proj
                n += dtr * di + di                   # dt_proj
                n += di * ds + di                    # A_log, D
                n += di * D                          # out_proj
            else:  # mamba2
                nh = self.ssm_n_heads
                n += D * (2 * di + 2 * ds + nh)      # in_proj (x,z,B,C,dt)
                n += (di + 2 * ds) * self.ssm_conv   # conv over x,B,C
                n += 2 * nh                          # A_log, D (per head)
                n += di * D                          # out_proj
            return n
        # attention
        if self.attn_kind == "gqa":
            hd = self.resolved_head_dim
            n += D * self.n_heads * hd               # q
            n += 2 * D * self.n_kv_heads * hd        # k, v
            n += self.n_heads * hd * D               # o
        elif self.attn_kind == "mla":
            r, qr = self.kv_lora_rank, self.q_lora_rank
            qk = self.qk_nope_dim + self.qk_rope_dim
            H, vh = self.n_heads, self.v_head_dim
            if qr:
                n += D * qr + qr * H * qk
            else:
                n += D * H * qk
            n += D * (r + self.qk_rope_dim)          # kv down + rope k
            n += r * H * (self.qk_nope_dim + vh)     # kv up
            n += H * vh * D                          # o
        # ffn
        moe_layer = self.n_experts > 0 and layer >= self.first_k_dense
        if moe_layer:
            e = self.experts_per_token if active_only else self.n_experts
            n += 3 * D * self.moe_d_ff * e
            n += 3 * D * self.moe_d_ff * self.n_shared_experts
            n += D * self.n_experts                  # router
        else:
            mult = 3 if self.act == "swiglu" else 2
            n += mult * D * self.d_ff
        return n


@dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    mode: str                        # train | prefill | decode
    sliding_window: int = 0          # >0: ring-buffer KV cache (long_500k on attn archs)


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode", sliding_window=8_192),
}


@dataclass(frozen=True)
class HardwareSpec:
    """The rates the roofline divides by (``launch/roofline.py``)."""

    peak_flops: float                # dense bf16 FLOP/s per device
    hbm_bw: float                    # bytes/s of device memory
    ici_bw: float                    # bytes/s a direction between devices


# NVIDIA H100 80GB HBM3 (SXM5), power limit 700 W, from NVIDIA's H100
# Tensor Core GPU datasheet: 989 TFLOP/s of dense bf16 tensor-core work,
# 3.35 TB/s of HBM3, and NVLink 4's 900 GB/s a GPU, 450 GB/s a direction.
# A card set below 700 W runs slower under load than these rates.
H100_SXM = HardwareSpec(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9)
