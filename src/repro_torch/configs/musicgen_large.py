"""musicgen-large — decoder-only over EnCodec tokens. [arXiv:2306.05284]

The EnCodec frontend is a stub, as in the reference: the decoder consumes
4 parallel codebook token streams (vocabulary 2048 each; their embeddings
summed on the way in, one logit head per codebook on the way out; the
delay pattern is the data pipeline's).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    source="arXiv:2306.05284",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    attn_kind="gqa",
    act="gelu",
    frontend="audio",
    n_codebooks=4,
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                        d_ff=512, vocab_size=128, n_codebooks=2)
