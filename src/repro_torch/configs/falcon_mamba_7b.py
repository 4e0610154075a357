"""falcon-mamba-7b — attention-free Mamba1. [arXiv:2410.05355]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    source="arXiv:2410.05355",
    n_layers=64,
    d_model=4096,
    vocab_size=65024,
    attn_kind="none",
    d_ff=0,
    ssm_variant="mamba1",
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=256, vocab_size=512, ssm_state=8)
