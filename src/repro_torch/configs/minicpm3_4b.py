"""minicpm3-4b — dense with MLA attention. [hf:openbmb/MiniCPM3-4B]

MLA: q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64, 40 heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    arch_type="dense",
    source="hf:openbmb/MiniCPM3-4B",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attn_kind="mla",
    kv_lora_rank=256,
    q_lora_rank=768,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    act="swiglu",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                        d_ff=512, vocab_size=512, kv_lora_rank=64,
                        q_lora_rank=96, qk_nope_dim=32, qk_rope_dim=16,
                        v_head_dim=32)
