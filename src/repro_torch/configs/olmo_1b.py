"""olmo-1b — dense, non-parametric LayerNorm. [arXiv:2402.00838]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    arch_type="dense",
    source="arXiv:2402.00838",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    attn_kind="gqa",
    act="swiglu",
    norm="np_layernorm",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                        d_ff=512, vocab_size=512)
