"""Unified model API (port of ``repro/models/model.py``, dense branch).

    init_params(cfg, seed, dtype, device)        -> Transformer
    init_cache(cfg, batch, max_seq, dtype)       -> cache dict
    decode_step(params, cache, token, pos, cfg)  -> (logits, cache)

Other ``arch_type``s raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf_lib


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.arch_type != "dense" or cfg.num_experts:
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} is not ported yet")


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> tf_lib.Transformer:
    _dense_only(cfg)
    return tf_lib.init_params(cfg, seed, dtype, device)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    _dense_only(cfg)
    return tf_lib.init_cache(cfg, batch, max_seq, dtype, device)


def decode_step(params, cache, token, pos, cfg: ModelConfig):
    _dense_only(cfg)
    return tf_lib.decode_step(params, cache, token, pos, cfg)
