"""OLMoE-1B-7B [moe] — 64 experts, top-8 [arXiv:2409.02060].

16L d_model=2048 16H (kv=16) per-expert d_ff=1024 vocab=50304.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    arch_type="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    moe_d_ff=1024,
    activation="silu",
    source="arXiv:2409.02060",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        name="olmoe-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=128, vocab_size=256,
        num_experts=4, experts_per_token=2, moe_d_ff=128)
