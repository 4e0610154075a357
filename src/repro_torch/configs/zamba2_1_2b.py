"""zamba2-1.2b — hybrid Mamba2 backbone + shared attention block. [arXiv:2411.15242]

38 Mamba2 layers; a single weight-shared attention(+MLP) block is invoked
every 6 layers (Zamba2's shared-transformer design).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    attn_kind="gqa",
    act="swiglu",
    ssm_variant="mamba2",
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    attn_every=6,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                        d_ff=512, vocab_size=512, ssm_state=16,
                        ssm_head_dim=64, attn_every=2)
