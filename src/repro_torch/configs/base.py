"""Config system for the PyTorch port: the dense, mixture-of-experts,
state-space, hybrid and encoder-decoder fields of the reference's
``repro.configs.base``, its aliases and ``ARCH_IDS`` (a copy, so the port
imports nothing of ``repro``; ``INPUT_SHAPES`` is not copied yet).

Each architecture file defines ``CONFIG`` (the published shape, cited)
and ``reduced()`` (a tiny same-family variant for CPU tests).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class LoRAConfig:
    """HLoRA adapter configuration: every adapter is allocated at
    ``r_max`` and carries a rank mask (see ``core/lora.py``)."""
    targets: Tuple[str, ...] = ("q", "k", "v", "o")
    r_max: int = 8
    alpha: float = 16.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    # "dense", "moe", "ssm", "hybrid", "vlm" (decoders), "encoder" or
    # "audio"; "hybrid" is Hymba's: attention and SSD heads in parallel in
    # every layer; "vlm" is Chameleon's early fusion, the dense decoder over
    # token ids; "audio" is Whisper's encoder-decoder
    arch_type: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0          # per-expert ffn width (defaults to d_ff)
    moe_shared: bool = False   # llama4-style always-on shared expert
    moe_group_size: int = 1024  # tokens per dispatch group
    moe_capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    sliding_window: Optional[int] = None   # None = full attention
    rope_theta: float = 10000.0
    activation: str = "silu"   # silu | geglu | gelu
    use_bias: bool = False
    # encoder-decoder (whisper): encoder depth and its frames a clip
    encoder_layers: int = 0
    encoder_seq: int = 1500
    num_classes: int = 0       # encoder-only classification (roberta)
    tie_embeddings: bool = False
    lora: LoRAConfig = field(default_factory=LoRAConfig)
    source: str = ""           # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count of the base model (no LoRA); MoE layers
        count every expert and the router, an SSM layer its ``in_proj``
        (x -> [z, x, B, C, dt]) and ``out_proj`` and no attention, a hybrid
        layer both its attention and those two projections. An
        encoder-decoder adds the encoder's layers (self-attention and MLP)
        and each decoder layer's cross-attention, as the reference does;
        like the reference, it counts an untied head unless
        ``tie_embeddings`` is set, which Whisper's config leaves False."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d
        if self.num_classes:
            head = d * self.num_classes
        else:
            head = 0 if self.tie_embeddings else self.vocab_size * d
        attn = 0
        if self.arch_type != "ssm":
            attn += (2 * d * self.num_heads * hd
                     + 2 * d * self.num_kv_heads * hd)
        if self.arch_type in ("ssm", "hybrid"):
            di = self.d_inner
            proj_out = 2 * di + 2 * self.ssm_state + self.ssm_heads
            attn += d * proj_out + di * d
        if self.num_experts:
            width = self.moe_d_ff or self.d_ff
            ffn = self.num_experts * 3 * d * width + d * self.num_experts
        else:
            mult = 3 if self.activation in ("silu", "geglu") else 2
            ffn = mult * d * self.d_ff
        total = emb + head + self.num_layers * (attn + ffn)
        if self.encoder_layers:
            total += (self.encoder_layers * (4 * d * d + 2 * d * self.d_ff)
                      + self.num_layers * 4 * d * d)
        return total

    def active_param_count(self) -> int:
        """Parameters a token passes through (MoE: its top-k experts)."""
        if not self.num_experts:
            return self.param_count()
        width = self.moe_d_ff or self.d_ff
        inactive = ((self.num_experts - self.experts_per_token) * 3
                    * self.d_model * width)
        return self.param_count() - self.num_layers * inactive


# The reference's configs in its order (``list_archs``); every one resolves
# in the port.
ARCH_IDS = (
    "hymba_1_5b",
    "mamba2_2_7b",
    "minitron_4b",
    "llama4_maverick_400b_a17b",
    "whisper_small",
    "chameleon_34b",
    "olmoe_1b_7b",
    "granite_34b",
    "gemma_2b",
    "command_r_plus_104b",
    "roberta_large",  # the paper's own model
)

_ALIASES = {
    "hymba-1.5b": "hymba_1_5b",
    "mamba2-2.7b": "mamba2_2_7b",
    "minitron-4b": "minitron_4b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "whisper-small": "whisper_small",
    "chameleon-34b": "chameleon_34b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-34b": "granite_34b",
    "gemma-2b": "gemma_2b",
    "command-r-plus-104b": "command_r_plus_104b",
    "roberta-large": "roberta_large",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_reduced(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.reduced()


def list_archs():
    return list(ARCH_IDS)
