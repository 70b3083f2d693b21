"""Hymba-1.5B [hybrid] — parallel attention + mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
d_inner = 2*d_model = 3200, head_dim 64 -> 50 SSD heads beside the 25
attention heads of every layer. Most layers of the published model use
sliding-window attention; here every layer does, with a 2k window, so
decode keeps a ring of 2048 K/V slots beside the SSD state.
"""
from repro_torch.configs.base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    sliding_window=2048,
    activation="silu",
    lora=LoRAConfig(targets=("q", "k", "v", "o", "ssm_in", "ssm_out")),
    source="arXiv:2411.13676",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        name="hymba-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256,
        ssm_state=16, ssm_head_dim=32, sliding_window=64)
