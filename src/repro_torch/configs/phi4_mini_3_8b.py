"""phi4-mini-3.8b — dense, RoPE SwiGLU GQA (kv=8). [arXiv:2412.08905]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    arch_type="dense",
    source="arXiv:2412.08905",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    attn_kind="gqa",
    act="swiglu",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                        head_dim=64, d_ff=512, vocab_size=512)
