"""Llama4-Maverick-400B-A17B [moe] — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts
top-1 routing + shared expert (llama4 style).
"""
from repro_torch.configs.base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,           # shared-expert / dense-path width
    vocab_size=202048,
    num_experts=128,
    experts_per_token=1,
    moe_d_ff=8192,
    moe_shared=True,
    activation="silu",
    lora=LoRAConfig(targets=("q", "k", "v", "o")),  # not on routed experts
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        name="llama4-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256,
        num_experts=4, experts_per_token=1, moe_d_ff=256)
