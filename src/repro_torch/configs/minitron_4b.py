"""Minitron-4B [dense] — pruned Nemotron [arXiv:2407.14679].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    activation="silu",
    source="arXiv:2407.14679",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        name="minitron-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256)
