"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    attn_kind="gqa",
    act="swiglu",
    n_experts=16,
    experts_per_token=1,
    n_shared_experts=1,
    moe_d_ff=8192,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                        head_dim=64, d_ff=512, vocab_size=512, n_experts=4,
                        experts_per_token=1, n_shared_experts=1, moe_d_ff=256)
