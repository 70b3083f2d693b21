"""Whisper (arXiv:2212.04356) in PyTorch (port of
``repro/models/whisper.py``): a transformer encoder-decoder.

As in the reference, the mel-spectrogram and conv front end are a stub:
the model takes precomputed frame embeddings ``frames`` (B, S_enc, d), what
the conv stack would emit. The bidirectional encoder, the causal decoder
with cross-attention and the decode caches are whole.

The model is a ``transformer.Transformer`` whose tree holds the
reference's layout: ``embed`` (tied to the head), ``encoder`` (``ln1``,
``attn``, ``ln2``, ``mlp`` stacked over ``encoder_layers``), ``enc_norm``,
``layers`` (``ln1``, ``attn``, ``lnx``, ``xattn``, ``ln2``, ``mlp``),
``final_norm`` and ``lora``. The adapters sit on the decoder's
self-attention and MLP, never on cross-attention or the encoder, as in the
reference. The reference's ``lax.scan`` over layers is a Python loop over
per-layer views (``transformer.run_layers`` for the decoder, with
``remat`` per layer where autograd records; the encoder, which the
reference does not checkpoint, a plain loop).

Decode keeps the reference's cache: ``{"self": {"k", "v", "pos"},
"cross_k", "cross_v"}``, the self-attention cache written in place a token
at a time and the stacked cross K/V, filled once by ``prefill_cache`` from
the encoder's output, only read. Under the default bfloat16 cache with
float32 weights, attention returns the cache's dtype; each attention
output is cast up to its output projection's dtype before the product,
an exact conversion (the reference itself refuses that mix: its
``cache_insert`` will not write float32 K/V into a bfloat16 cache). The
training forward needs no cast: its K/V are in the weights' dtype.

The reference's ``shard_hints.constrain_tokens`` on a layer's input is a
no-op off a device mesh; the port has no mesh, so the call is left out.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf_lib
from repro_torch.models.common import (attention, cache_insert,
                                       init_kv_cache, mlp, out_proj,
                                       qkv_proj, sinusoidal_positions)
from repro_torch.models.transformer import norm


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> tf_lib.Transformer:
    """The reference's tree from one generator seeded with ``seed`` on
    ``device`` (None = CUDA): the encoder's attention and MLP, the
    decoder's self-attention, cross-attention and MLP, the embedding and
    the adapters, drawn in that order; layer norms at ones and zeros. The
    reference's distributions; not the same numbers."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    d, Le, Ld = cfg.d_model, cfg.encoder_layers, cfg.num_layers

    def ln(*shape):
        return tf_lib.init_norm(shape, True, dtype, dev)

    encoder = {"ln1": ln(Le, d),
               "attn": tf_lib.init_attn(gen, cfg, Le, dtype),
               "ln2": ln(Le, d),
               "mlp": tf_lib.init_mlp(gen, cfg, Le, dtype)}
    layers = {"ln1": ln(Ld, d),
              "attn": tf_lib.init_attn(gen, cfg, Ld, dtype),
              "lnx": ln(Ld, d),
              "xattn": tf_lib.init_attn(gen, cfg, Ld, dtype),
              "ln2": ln(Ld, d),
              "mlp": tf_lib.init_mlp(gen, cfg, Ld, dtype)}
    tree = {"embed": tf_lib.init_embed(gen, cfg, dtype), "encoder": encoder,
            "enc_norm": ln(d), "layers": layers, "final_norm": ln(d)}
    return tf_lib.Transformer(cfg, tree,
                              tf_lib.init_lora(gen, cfg, device=dev))


def _positions(s: int, d: int, dtype, device, start: int = 0
               ) -> torch.Tensor:
    pos = torch.arange(start, start + s, device=device)[None, :]
    return sinusoidal_positions(pos, d).to(dtype)


def encode(params: tf_lib.Transformer, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames (B, S_enc, d) stub embeddings -> (B, S_enc, d): sinusoidal
    positions added, then ``encode_layers``."""
    return encode_layers(params, frames + _positions(
        frames.shape[1], cfg.d_model, frames.dtype, frames.device), cfg)


def encode_layers(params: tf_lib.Transformer, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Every encoder layer (bidirectional attention in the default query
    chunks of 1024, as the reference's ``encode``), then ``enc_norm``, on
    x (B, S_enc, d), the frames with their positions."""
    for lp in tf_lib.unbind_layers(params.encoder_groups(),
                                   cfg.encoder_layers):
        q, k, v = qkv_proj(norm(x, lp["ln1"]), lp["attn"], cfg, None)
        x = x + out_proj(attention(q, k, v, causal=False), lp["attn"], cfg,
                         None)
        x = x + mlp(norm(x, lp["ln2"]), lp["mlp"], cfg, None)
    return norm(x, params.enc_norm.as_dict())


def apply_q(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> torch.Tensor:
    """Cross-attention's queries (B, S, H, Dh); no adapter."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    if cfg.use_bias:
        q = q + p["bq"]
    return q.reshape(b, s, cfg.num_heads, cfg.resolved_head_dim)


def cross_kv(enc_out: torch.Tensor, p: Dict[str, torch.Tensor],
             cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention's K and V (B, S_enc, Hkv, Dh) from the encoder's
    output; no adapter."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k, v = enc_out @ p["wk"], enc_out @ p["wv"]
    if cfg.use_bias:
        k, v = k + p["bk"], v + p["bv"]
    return (k.reshape(b, s, cfg.num_kv_heads, hd),
            v.reshape(b, s, cfg.num_kv_heads, hd))


def _up(att: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """An attention output in its output projection's dtype (a bfloat16
    cache against float32 weights: exact)."""
    return att.to(p["wo"].dtype)


def dec_layer(x: torch.Tensor, lp: Dict, ad: tf_lib.LoraTree,
              enc_kv: Tuple[torch.Tensor, torch.Tensor], cfg: ModelConfig,
              *, q_chunk: int = 1024) -> torch.Tensor:
    """One decoder layer over a whole sequence, x: (B, S, d): causal
    self-attention (the layer's adapters on q, k, v and o), cross-attention
    on ``enc_kv`` (no adapter), the MLP (the layer's adapters)."""
    q, k, v = qkv_proj(norm(x, lp["ln1"]), lp["attn"], cfg, ad)
    att = attention(q, k, v, causal=True, q_chunk=q_chunk)
    x = x + out_proj(att, lp["attn"], cfg, ad)
    qx = apply_q(norm(x, lp["lnx"]), lp["xattn"], cfg)
    kx, vx = enc_kv
    attx = attention(qx, kx, vx, causal=False, q_chunk=q_chunk)
    x = x + out_proj(attx, lp["xattn"], cfg, None)
    return x + mlp(norm(x, lp["ln2"]), lp["mlp"], cfg, ad)


def _embed(params: tf_lib.Transformer, tokens: torch.Tensor,
           cfg: ModelConfig, start: int = 0) -> torch.Tensor:
    """``embed[t] * sqrt(d) + sinusoidal(position)``."""
    x = params.embed[tokens.long()]
    return x * math.sqrt(cfg.d_model) + _positions(
        tokens.shape[1], cfg.d_model, x.dtype, x.device, start)


def forward(params: tf_lib.Transformer, tokens: torch.Tensor,
            cfg: ModelConfig, *, frames: Optional[torch.Tensor] = None,
            remat: bool = True, q_chunk: int = 1024
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward: tokens (B, S) int and ``frames`` (B, S_enc,
    d) -> (logits (B, S, V), aux = a float32 zero). Each decoder layer
    forms its cross K/V from the encoder's output itself, so ``remat``
    recomputes them with the layer."""
    if frames is None:
        raise ValueError("whisper needs frame embeddings: batch['frames']")
    enc_out = encode(params, frames, cfg)
    x = _embed(params, tokens, cfg)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(x, lp, ad):
        kv = cross_kv(enc_out, lp["xattn"], cfg)
        return dec_layer(x, lp, ad, kv, cfg, q_chunk=q_chunk), zero

    x, aux = tf_lib.run_layers(params, x, cfg, layer, remat)
    return norm(x, params.final_norm.as_dict()) @ params.head(), aux


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Dict:
    """The self-attention cache (``init_kv_cache``) and zero cross K/V
    (L, B, S_enc, Hkv, Dh), on ``device`` (None = CUDA);
    ``prefill_cache`` fills the cross K/V."""
    dev = resolve_device(device)
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads, hd)
    return {"self": init_kv_cache(cfg.num_layers, batch, max_seq,
                                  cfg.num_kv_heads, hd, dtype=dtype,
                                  device=dev),
            "cross_k": torch.zeros(shape, dtype=dtype, device=dev),
            "cross_v": torch.zeros(shape, dtype=dtype, device=dev)}


@torch.no_grad()
def prefill_cache(params: tf_lib.Transformer, frames: torch.Tensor,
                  cfg: ModelConfig, batch: int, max_seq: int,
                  dtype=torch.bfloat16) -> Dict:
    """Run the encoder once and fill every layer's cross K/V, in
    ``dtype``, on the frames' device."""
    enc_out = encode(params, frames, cfg)
    cache = init_cache(cfg, batch, max_seq, dtype, frames.device)
    for layer in range(cfg.num_layers):
        k, v = cross_kv(enc_out, params.layers["xattn"].as_dict(layer), cfg)
        cache["cross_k"][layer].copy_(k)
        cache["cross_v"][layer].copy_(v)
    return cache


@torch.no_grad()
def decode_step(params: tf_lib.Transformer, cache: Dict, token: torch.Tensor,
                pos: int, cfg: ModelConfig):
    """token: (B, 1) int, pos: absolute position. Returns (logits (B, V),
    cache); the self-attention cache is written in place, the cross K/V
    only read."""
    x = _embed(params, token, cfg, pos)
    for layer in range(cfg.num_layers):
        lp = params.layer(layer)
        ad = tf_lib.layer_slice(params.lora, layer)
        q, k, v = qkv_proj(norm(x, lp["ln1"]), lp["attn"], cfg, ad)
        lc = cache_insert({n: c[layer] for n, c in cache["self"].items()},
                          k, v, pos)
        att = attention(q, lc["k"], lc["v"], causal=True, q_offset=pos,
                        kv_positions=lc["pos"], kv_valid=lc["pos"] >= 0)
        x = x + out_proj(_up(att, lp["attn"]), lp["attn"], cfg, ad)
        qx = apply_q(norm(x, lp["lnx"]), lp["xattn"], cfg)
        attx = attention(qx, cache["cross_k"][layer],
                         cache["cross_v"][layer], causal=False)
        x = x + out_proj(_up(attx, lp["xattn"]), lp["xattn"], cfg, None)
        x = x + mlp(norm(x, lp["ln2"]), lp["mlp"], cfg, ad)
    x = norm(x, params.final_norm.as_dict())
    return x[:, 0, :] @ params.head(), cache
