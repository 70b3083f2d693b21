"""Whisper-small [audio]: encoder-decoder, conv front end a stub
[arXiv:2212.04356].

12-layer decoder and 12-layer encoder, d_model 768, 12 heads, d_ff 3072,
vocab 51865. As in the reference, the mel-spectrogram and conv feature
extractor are a stub: the model takes precomputed frame embeddings
(batch, 1500, 768).
"""
from repro_torch.configs.base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="audio",
    num_layers=12,
    encoder_layers=12,
    encoder_seq=1500,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    activation="gelu",
    use_bias=True,
    rope_theta=0.0,  # sinusoidal positions, no RoPE
    lora=LoRAConfig(targets=("q", "v")),  # the Whisper-LoRA convention
    source="arXiv:2212.04356",
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        name="whisper-reduced", num_layers=2, encoder_layers=2,
        encoder_seq=32, d_model=128, num_heads=4, num_kv_heads=4,
        head_dim=32, d_ff=256, vocab_size=256)
