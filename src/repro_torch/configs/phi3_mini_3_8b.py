"""phi3-mini-3.8b — dense, RoPE SwiGLU GQA. [arXiv:2404.14219]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    arch_type="dense",
    source="arXiv:2404.14219",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    attn_kind="gqa",
    act="swiglu",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                        d_ff=512, vocab_size=512)
