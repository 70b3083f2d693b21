"""Unified model API (port of ``repro/models/model.py``, dense decoder and
encoder classifier branches).

    init_params(cfg, seed, dtype, device)              -> Transformer
    forward(params, batch, cfg, remat=, q_chunk=)      -> logits
    loss_fn(params, batch, cfg, remat=, q_chunk=)      -> (loss, metrics)
    init_cache(cfg, batch, max_seq, dtype)             -> cache dict
    decode_step(params, cache, token, pos, cfg)        -> (logits, cache)

``batch``: {"tokens": (B, S) int, "labels": (B,) int for a classifier,
(B, S) int next tokens for a decoder (< 0: not scored)}. ``loss_fn`` is
differentiable in whichever tensors of ``params`` require grad: the
adapters and head in client training, every tensor in backbone
pretraining (``fed/simulation.py::pretrain_backbone``) and LM training
(``examples/lm_pretrain_torch.py``). ``remat`` and ``q_chunk`` default to
the reference's (per-layer recomputation on, chunks of 1024 queries); the
federated trainers pass ``remat=False`` as the reference's do. Unlike the
reference, ``forward`` returns only the logits (the dense families have no
auxiliary loss). Other ``arch_type``s raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf_lib

MOE_AUX_WEIGHT = 0.01


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
            cfg: ModelConfig, *, remat: bool = True,
            q_chunk: int = 1024) -> torch.Tensor:
    _ported(cfg)
    return tf_lib.forward(params, batch["tokens"], cfg, remat=remat,
                          q_chunk=q_chunk,
                          causal=cfg.arch_type != "encoder")


def loss_fn(params: tf_lib.Transformer, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, *, remat: bool = True, q_chunk: int = 1024
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sequence classification: mean NLL of the labels under the float32
    log-softmax, and accuracy of the argmax. Next-token LM: the labels are
    already shifted by the data; the NLL is logsumexp of the float32 logits
    less the label's logit, averaged over the labels >= 0 (none: 0)."""
    logits = forward(params, batch, cfg, remat=remat, q_chunk=q_chunk)
    labels = batch["labels"].long()
    if cfg.num_classes:
        logp = F.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, labels[:, None]).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return nll, {"loss": nll, "acc": acc}
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)                            # (B, S)
    # the reference sums an iota-pick over the vocabulary; every other
    # term is an exact 0, so the gather is the same number
    safe = torch.clamp(labels, min=0)
    label_logit = lg.gather(-1, safe[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = torch.sum((lse - label_logit) * mask) / torch.clamp(mask.sum(),
                                                              min=1.0)
    aux = torch.zeros((), dtype=torch.float32, device=lg.device)
    total = nll + MOE_AUX_WEIGHT * aux
    return total, {"loss": total, "nll": nll, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    _decoder_only(cfg)
    return tf_lib.init_cache(cfg, batch, max_seq, dtype, device)


def decode_step(params, cache, token, pos, cfg: ModelConfig):
    _decoder_only(cfg)
    return tf_lib.decode_step(params, cache, token, pos, cfg)
