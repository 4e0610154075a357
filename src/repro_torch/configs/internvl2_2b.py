"""internvl2-2b — VLM: InternViT (stubbed frontend) + InternLM2 backbone.
[arXiv:2404.16821]

The vision encoder is a stub, as in the reference: a batch carries
precomputed patch embeddings ``vision_embeds`` (n_patches x d_model),
which the model puts before the text token embeddings; the language
backbone is what runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    arch_type="vlm",
    source="arXiv:2404.16821",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    attn_kind="gqa",
    act="swiglu",
    frontend="vision",
    n_patches=1024,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                        d_ff=512, vocab_size=512, n_patches=16)
