"""Chameleon-34B [vlm] — early-fusion, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 (text + 8192 VQ
image codes in one vocab). Early fusion means the backbone is a plain
decoder over interleaved token ids; the VQ-VAE image tokenizer is a STUB,
as in the reference (the inputs are token ids already), so ``vlm`` runs
the dense transformer (``models/model.py``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    activation="silu",
    source="arXiv:2405.09818",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        name="chameleon-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256)
