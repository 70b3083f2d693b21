"""RoBERTa-large [encoder] — the paper's own evaluation model
[arXiv:1907.11692].

24L d_model=1024 16H d_ff=4096 vocab=50265, classification head.
LoRA on q,v with r=8 (the paper's / Hu et al.'s GLUE setting).
"""
from repro_torch.configs.base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="roberta-large",
    arch_type="encoder",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=50265,
    num_classes=2,
    activation="gelu",
    use_bias=True,
    rope_theta=0.0,  # learned positions in roberta; a sinusoidal stand-in
    lora=LoRAConfig(targets=("q", "v"), r_max=8, alpha=16.0),
    source="arXiv:1907.11692",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        name="roberta-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=256)
