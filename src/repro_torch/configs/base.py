"""Config system for the PyTorch port: the dense and mixture-of-experts
fields of the reference's ``repro.configs.base`` (a copy, so the port
imports nothing of ``repro``).

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
    arch_type: str  # "dense", "moe" (decoders) or "encoder" (classifier)
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
    sliding_window: Optional[int] = None   # None = full attention
    rope_theta: float = 10000.0
    activation: str = "silu"   # silu | geglu | gelu
    use_bias: bool = False
    num_classes: int = 0       # encoder-only classification (roberta)
    tie_embeddings: bool = False
    lora: LoRAConfig = field(default_factory=LoRAConfig)
    source: str = ""           # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count of the base model (no LoRA); MoE layers
        count every expert and the router."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d
        if self.num_classes:
            head = d * self.num_classes
        else:
            head = 0 if self.tie_embeddings else self.vocab_size * d
        attn = 2 * d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
        if self.num_experts:
            width = self.moe_d_ff or self.d_ff
            ffn = self.num_experts * 3 * d * width + d * self.num_experts
        else:
            mult = 3 if self.activation in ("silu", "geglu") else 2
            ffn = mult * d * self.d_ff
        return emb + head + self.num_layers * (attn + ffn)

    def active_param_count(self) -> int:
        """Parameters a token passes through (MoE: its top-k experts)."""
        if not self.num_experts:
            return self.param_count()
        width = self.moe_d_ff or self.d_ff
        inactive = ((self.num_experts - self.experts_per_token) * 3
                    * self.d_model * width)
        return self.param_count() - self.num_layers * inactive


_ALIASES = {
    "gemma-2b": "gemma_2b",
    "minitron-4b": "minitron_4b",
    "roberta-large": "roberta_large",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_reduced(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.reduced()
