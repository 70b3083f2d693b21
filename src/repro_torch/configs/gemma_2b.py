"""Gemma-2B [dense] — GeGLU, head_dim=256, MQA [arXiv:2403.08295].

18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    arch_type="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    tie_embeddings=True,
    source="arXiv:2403.08295",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        name="gemma-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=1, head_dim=32, d_ff=256, vocab_size=256)
