"""Config system for the PyTorch port: the dense fields of the reference's
``repro.configs.base`` (a copy, so the port imports nothing of ``repro``).

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
    arch_type: str  # "dense" (decoder) or "encoder" (classifier) so far
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    num_experts: int = 0
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
        """Analytic parameter count of the dense base model (no LoRA)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d
        if self.num_classes:
            head = d * self.num_classes
        else:
            head = 0 if self.tie_embeddings else self.vocab_size * d
        attn = 2 * d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
        mult = 3 if self.activation in ("silu", "geglu") else 2
        return emb + head + self.num_layers * (attn + mult * d * self.d_ff)


_ALIASES = {
    "gemma-2b": "gemma_2b",
    "minitron-4b": "minitron_4b",
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
