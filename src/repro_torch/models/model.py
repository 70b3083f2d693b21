"""Unified model API (port of ``repro/models/model.py``, dense decoder and
encoder classifier branches).

    init_params(cfg, seed, dtype, device)        -> Transformer
    forward(params, batch, cfg)                  -> logits
    loss_fn(params, batch, cfg)                  -> (loss, metrics)
    init_cache(cfg, batch, max_seq, dtype)       -> cache dict
    decode_step(params, cache, token, pos, cfg)  -> (logits, cache)

``batch``: {"tokens": (B, S) int, "labels": (B,) int}. ``loss_fn`` is
differentiable in whichever tensors of ``params`` require grad: the
adapters and head in client training, every tensor in backbone
pretraining (``fed/simulation.py::pretrain_backbone``). Other
``arch_type``s raise ``NotImplementedError``; so does the next-token LM
loss, which waits for the training launcher.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf_lib


def _ported(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ("dense", "encoder") or cfg.num_experts:
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} is not ported yet")


def _decoder_only(cfg: ModelConfig) -> None:
    _ported(cfg)
    if cfg.arch_type == "encoder":
        raise ValueError("encoder-only model has no decode path")


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> tf_lib.Transformer:
    _ported(cfg)
    return tf_lib.init_params(cfg, seed, dtype, device)


def forward(params: tf_lib.Transformer, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    _ported(cfg)
    return tf_lib.forward(params, batch["tokens"], cfg,
                          causal=cfg.arch_type != "encoder")


def loss_fn(params: tf_lib.Transformer, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sequence classification: mean NLL of the labels under the float32
    log-softmax, and accuracy of the argmax."""
    if not cfg.num_classes:
        raise NotImplementedError("the next-token LM loss is not ported yet")
    logits = forward(params, batch, cfg)
    labels = batch["labels"].long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll, {"loss": nll, "acc": acc}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    _decoder_only(cfg)
    return tf_lib.init_cache(cfg, batch, max_seq, dtype, device)


def decode_step(params, cache, token, pos, cfg: ModelConfig):
    _decoder_only(cfg)
    return tf_lib.decode_step(params, cache, token, pos, cfg)
