"""Command-R-Plus-104B [dense] — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01].

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    arch_type="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    activation="silu",
    use_bias=False,
    source="hf:CohereForAI/c4ai-command-r-v01",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        name="command-r-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256)
