"""Mamba2-2.7B [ssm] — SSD state-space duality [arXiv:2405.21060].

64L d_model=2560 attention-free, vocab=50280, ssm_state=128.
d_inner = 2*d_model = 5120, head_dim 64 -> 80 SSD heads.
"""
from repro_torch.configs.base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    activation="silu",
    tie_embeddings=True,
    lora=LoRAConfig(targets=("ssm_in", "ssm_out")),
    source="arXiv:2405.21060",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        name="mamba2-reduced", num_layers=2, d_model=128,
        vocab_size=256, ssm_state=16, ssm_head_dim=32)
