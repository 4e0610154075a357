"""deepseek-v2-236b — MoE with MLA. [arXiv:2405.04434]

MLA kv_lora=512, q_lora=1536, qk_nope=128, qk_rope=64, v_head=128.
MoE: 2 shared + 160 routed experts, top-6, per-expert d_ff=1536; first layer dense.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    source="arXiv:2405.04434",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,                # dense layers' FFN (DeepSeek-V2 inter size)
    vocab_size=102400,
    attn_kind="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    act="swiglu",
    n_experts=160,
    experts_per_token=6,
    n_shared_experts=2,
    moe_d_ff=1536,
    first_k_dense=1,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                        d_ff=512, vocab_size=512, kv_lora_rank=64,
                        q_lora_rank=96, qk_nope_dim=32, qk_rope_dim=16,
                        v_head_dim=32, n_experts=4, experts_per_token=2,
                        n_shared_experts=1, moe_d_ff=128, first_k_dense=1)
