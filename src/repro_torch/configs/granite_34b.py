"""Granite-34B-Code [dense] — llama-arch, MQA [arXiv:2405.04324].

88L d_model=6144 48H (GQA kv=1, i.e. MQA) d_ff=24576 vocab=49152; a plain
(not gated) GELU MLP and biases on the projections.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    arch_type="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    activation="gelu",
    use_bias=True,  # granite code models use bias
    source="arXiv:2405.04324",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        name="granite-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=1, head_dim=32, d_ff=256, vocab_size=256)
