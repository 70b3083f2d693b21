"""Hymba (arXiv:2411.13676) in PyTorch (port of ``repro/models/hymba.py``):
hybrid blocks with attention and Mamba2 SSD heads in PARALLEL on the same
normed input, their outputs averaged, then an MLP. Sliding-window
attention keeps long-context decode sub-quadratic; the SSD path carries
unbounded context in its state.

The model is a ``transformer.Transformer`` whose ``layers`` hold the
reference's five groups, ``ln1``, ``attn``, ``ssm``, ``ln2`` and ``mlp``,
beside an untied ``lm_head``; one layer's adapters hold ``q``/``k``/``v``/
``o`` for attention and ``ssm_in``/``ssm_out`` for the mixer, each
projection taking its own. The reference's ``lax.scan`` over layers is
``transformer.run_layers`` (``remat`` per layer) in training and a Python
loop over the stacked cache in decode.

The decode cache nests the dense ring and the SSD state, as the
reference's does: ``{"kv": {"k", "v", "pos"}, "ssm": {"conv", "state"}}``,
the ring ``min(sliding_window, max_seq)`` slots, updated in place layer by
layer. The conv window keeps the cache's dtype and the state is float32
(``models/model.py`` says why).

The reference's ``shard_hints.constrain_tokens`` on a layer's input is a
no-op off a device mesh; the port has no mesh, so the call is left out.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import mamba2 as ssm_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.common import (attention, cache_insert,
                                       init_kv_cache, mlp, out_proj,
                                       qkv_proj, rope)
from repro_torch.models.transformer import norm


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> tf_lib.Transformer:
    """``transformer.init_tree``'s weights and adapters, then the ``ssm``
    group (``mamba2.init_ssm_params``), all from one generator seeded with
    ``seed`` on ``device`` (None = CUDA). The reference's distributions;
    not the same numbers."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    tree, lora = tf_lib.init_tree(gen, cfg, dtype)
    tree["layers"]["ssm"] = ssm_lib.init_ssm_params(gen, cfg, cfg.num_layers,
                                                    dtype)
    return tf_lib.Transformer(cfg, tree, lora)


def hybrid_layer(x: torch.Tensor, lp: Dict, ad: tf_lib.LoraTree,
                 cfg: ModelConfig, *, positions: torch.Tensor,
                 q_chunk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block over a whole sequence. x: (B, S, d) -> (x, aux = a float32
    zero). Both branches read the same normed ``h``; the sum is the
    reference's, ``x + 0.5 * (att + ssm)`` in that order."""
    h = norm(x, lp["ln1"])
    q, k, v = qkv_proj(h, lp["attn"], cfg, ad)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    att = attention(q, k, v, causal=True, window=cfg.sliding_window,
                    q_chunk=q_chunk)
    att = out_proj(att, lp["attn"], cfg, ad)
    ssm = ssm_lib.mamba_mixer(h, lp["ssm"], cfg, ad)
    x = x + 0.5 * (att + ssm)
    y = mlp(norm(x, lp["ln2"]), lp["mlp"], cfg, ad)
    return x + y, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params: tf_lib.Transformer, tokens: torch.Tensor,
            cfg: ModelConfig, *, remat: bool = True, q_chunk: int = 1024
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int -> (logits (B, S, V), aux 0). S must be a multiple
    of the SSD chunk ``min(128, S)``."""
    s = tokens.shape[1]
    x = params.embed[tokens.long()]                          # (B, S, d)
    positions = torch.arange(s, device=x.device)[None, :]

    def layer(x, lp, ad):
        return hybrid_layer(x, lp, ad, cfg, positions=positions,
                            q_chunk=q_chunk)

    x, aux = tf_lib.run_layers(params, x, cfg, layer, remat)
    return norm(x, params.final_norm.as_dict()) @ params.head(), aux


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Dict:
    """{"kv": the ring (``init_kv_cache`` at the window), "ssm":
    ``init_ssm_cache``}, zeros on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    kv = init_kv_cache(cfg.num_layers, batch, max_seq, cfg.num_kv_heads,
                       cfg.resolved_head_dim, window=cfg.sliding_window,
                       dtype=dtype, device=dev)
    ssm = ssm_lib.init_ssm_cache(cfg, cfg.num_layers, batch, dtype, dev)
    return {"kv": kv, "ssm": ssm}


def layer_decode(x: torch.Tensor, lp: Dict, ad: tf_lib.LoraTree, lc: Dict,
                 pos: int, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One token through one layer. x: (B, 1, d); ``lc`` the layer's views
    {"kv": {"k", "v", "pos"}, "ssm": {"conv", "state"}}. The K/V slot is
    written in place; returns (x, {"kv": the same views, "ssm": the new
    conv window and state})."""
    h = norm(x, lp["ln1"])
    q, k, v = qkv_proj(h, lp["attn"], cfg, ad)
    pvec = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, pvec, cfg.rope_theta)
    k = rope(k, pvec, cfg.rope_theta)
    kvc = cache_insert(lc["kv"], k, v, pos)
    att = attention(q, kvc["k"], kvc["v"], causal=True,
                    window=cfg.sliding_window, q_offset=pos,
                    kv_positions=kvc["pos"], kv_valid=kvc["pos"] >= 0)
    att = out_proj(att, lp["attn"], cfg, ad)
    ssm, ssmc = ssm_lib.mamba_mixer_step(h, lc["ssm"], lp["ssm"], cfg, ad)
    x = x + 0.5 * (att + ssm)
    y = mlp(norm(x, lp["ln2"]), lp["mlp"], cfg, ad)
    return x + y, {"kv": kvc, "ssm": ssmc}


@torch.no_grad()
def decode_step(params: tf_lib.Transformer, cache: Dict, token: torch.Tensor,
                pos: int, cfg: ModelConfig):
    """token: (B, 1) int, pos: absolute position. Returns (logits (B, V),
    cache); both parts of the cache are updated in place."""
    x = params.embed[token]                                  # (B, 1, d)
    for layer in range(cfg.num_layers):
        lc = {part: {n: c[layer] for n, c in cache[part].items()}
              for part in ("kv", "ssm")}
        x, new = layer_decode(x, params.layer(layer),
                              tf_lib.layer_slice(params.lora, layer), lc,
                              pos, cfg)
        for n, c in lc["ssm"].items():
            c.copy_(new["ssm"][n])
    x = norm(x, params.final_norm.as_dict())
    return x[:, 0, :] @ params.head(), cache
