"""Dense transformer (port of the dense family of
``repro/models/transformer.py``): the decoder, and the RoBERTa-style
encoder classifier (``causal=False``, CLS pooling, a ``cls_head``).

The model is an ``nn.Module`` whose parameters keep the reference's
stacked layout: every per-layer weight is one ``(L, ...)`` tensor and
projections are ``(d_in, d_out)``, so ``x @ W0`` is the same product on
both sides and ``interop.py`` moves weights across one to one. The
reference's ``lax.scan`` over layers becomes a Python loop over
``Transformer.layer(l)``, which hands out per-layer views.

``Transformer.lora`` is the reference's ``params["lora"]``:
``{target: {"A": (L, d_in, r), "B": (L, r, d_out), "mask": (L, r)}}``;
``Transformer.cls`` holds a classifier's ``cls_head`` (d, C) and
``cls_bias`` (C,) (empty otherwise). Both are plain dicts of tensors, so a
trainer can put leaves that require grad in their place (``fed/client``).
"""
from __future__ import annotations

import copy
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import lora as lora_lib
from repro_torch.device import resolve_device
from repro_torch.models.common import (attention, cache_insert,
                                       init_kv_cache, layer_norm, mlp,
                                       out_proj, qkv_proj, rms_norm, rope,
                                       sinusoidal_positions)

LoraTree = Dict[str, lora_lib.Adapter]
HEAD_KEYS = ("cls_head", "cls_bias")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class ParamGroup(nn.Module):
    """A named group of (stacked) tensors, e.g. a layer's attention
    weights ``wq, wk, wv, wo``."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, _frozen(t))

    def as_dict(self, index: Optional[int] = None) -> Dict[str, torch.Tensor]:
        return {n: (p if index is None else p[index])
                for n, p in self.named_parameters(recurse=False)}


class Transformer(nn.Module):
    """Dense decoder or encoder: ``embed`` (V, d), stacked ``layers``
    groups ``ln1``/``attn``/``ln2``/``mlp``, ``final_norm``, optional
    ``lm_head`` (d, V) (tied to ``embed`` otherwise), and for classifiers
    ``cls`` = {``cls_head`` (d, C), ``cls_bias`` (C,)}."""

    GROUPS = ("ln1", "attn", "ln2", "mlp")

    def __init__(self, cfg: ModelConfig, tree: Dict, lora: LoraTree):
        super().__init__()
        self.cfg = cfg
        self.embed = _frozen(tree["embed"])
        self.layers = nn.ModuleDict(
            {g: ParamGroup(tree["layers"][g]) for g in self.GROUPS})
        self.final_norm = ParamGroup(tree["final_norm"])
        self.lm_head = (_frozen(tree["lm_head"]) if "lm_head" in tree
                        else None)
        self.lora = lora
        self.cls = {k: tree[k] for k in HEAD_KEYS if k in tree}

    def layer(self, index: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Layer ``index`` as the reference's per-layer param dict
        (views, no copies)."""
        return {g: self.layers[g].as_dict(index) for g in self.GROUPS}

    def head(self) -> torch.Tensor:
        return self.lm_head if self.lm_head is not None else self.embed.T

    def to_device(self, device) -> "Transformer":
        """A copy with every tensor (weights, adapters, head) on
        ``device``, e.g. the same weights on the CPU and on the card."""
        def move(node):
            if isinstance(node, dict):
                return {k: move(v) for k, v in node.items()}
            return node.detach().to(device)

        tree = {"embed": self.embed, "final_norm": self.final_norm.as_dict(),
                "layers": {g: self.layers[g].as_dict() for g in self.GROUPS},
                **self.cls}
        if self.lm_head is not None:
            tree["lm_head"] = self.lm_head
        return Transformer(self.cfg, move(tree), move(self.lora))

    def replace(self, group: str, name: str, value: torch.Tensor
                ) -> "Transformer":
        """A copy sharing every tensor except ``layers[group][name]``."""
        new = copy.copy(self)
        new._modules = dict(self._modules)
        layers = copy.copy(self.layers)
        layers._modules = dict(self.layers._modules)
        grp = copy.copy(self.layers[group])
        grp._parameters = dict(grp._parameters)
        grp._parameters[name] = _frozen(value)
        layers._modules[group] = grp
        new._modules["layers"] = layers
        new.lora = dict(self.lora)
        return new


def norm(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    if "b" in p:
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"])


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def lora_specs(cfg: ModelConfig) -> Dict[str, Tuple[int, int]]:
    """{target: (d_in, d_out)} for every configured LoRA target."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dims = {"q": (d, cfg.num_heads * hd), "k": (d, cfg.num_kv_heads * hd),
            "v": (d, cfg.num_kv_heads * hd), "o": (cfg.num_heads * hd, d),
            "w1": (d, cfg.d_ff), "w3": (d, cfg.d_ff), "w2": (cfg.d_ff, d)}
    specs = {}
    for t in cfg.lora.targets:
        if t not in dims:
            raise ValueError(f"unknown LoRA target {t!r}")
        specs[t] = dims[t]
    return specs


def init_lora(gen: torch.Generator, cfg: ModelConfig,
              rank: Optional[int] = None, dtype=torch.float32,
              device=None) -> LoraTree:
    specs = lora_specs(cfg)
    stack = {t: (cfg.num_layers,) for t in specs}
    return lora_lib.tree_init(gen, specs, cfg.lora.r_max, rank, stack, dtype,
                              device)


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> Transformer:
    """Random weights drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (None = CUDA). Same distributions as the
    reference (std 1/sqrt(d_in) projections, 0.02 embedding, zero norm
    weights); not the same numbers, since the generators differ."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    L, d, hd, ff = (cfg.num_layers, cfg.d_model, cfg.resolved_head_dim,
                    cfg.d_ff)

    def dense(*shape):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return w.mul_(1.0 / math.sqrt(shape[-2])).to(dtype)

    def norm_init(shape):
        p = {"w": torch.zeros(shape, dtype=dtype, device=dev)}
        if cfg.use_bias:
            p["w"] += 1.0
            p["b"] = torch.zeros(shape, dtype=dtype, device=dev)
        return p

    attn = {"wq": dense(L, d, cfg.num_heads * hd),
            "wk": dense(L, d, cfg.num_kv_heads * hd),
            "wv": dense(L, d, cfg.num_kv_heads * hd),
            "wo": dense(L, cfg.num_heads * hd, d)}
    mlp_p = {"w1": dense(L, d, ff), "w2": dense(L, ff, d)}
    if cfg.activation in ("silu", "geglu"):
        mlp_p["w3"] = dense(L, d, ff)
    if cfg.use_bias:
        for n, width in (("bq", cfg.num_heads * hd),
                         ("bk", cfg.num_kv_heads * hd),
                         ("bv", cfg.num_kv_heads * hd), ("bo", d)):
            attn[n] = torch.zeros((L, width), dtype=dtype, device=dev)
        mlp_p["b1"] = torch.zeros((L, ff), dtype=dtype, device=dev)
        mlp_p["b2"] = torch.zeros((L, d), dtype=dtype, device=dev)
    embed = torch.randn((cfg.vocab_size, d), generator=gen,
                        dtype=torch.float32, device=dev).mul_(0.02).to(dtype)
    tree = {"embed": embed,
            "layers": {"ln1": norm_init((L, d)), "attn": attn,
                       "ln2": norm_init((L, d)), "mlp": mlp_p},
            "final_norm": norm_init((d,))}
    lora = init_lora(gen, cfg, device=dev)
    if cfg.num_classes:
        tree["cls_head"] = dense(d, cfg.num_classes)
        tree["cls_bias"] = torch.zeros((cfg.num_classes,), dtype=dtype,
                                       device=dev)
    elif not cfg.tie_embeddings:
        tree["lm_head"] = dense(d, cfg.vocab_size)
    return Transformer(cfg, tree, lora)


# ---------------------------------------------------------------------------
# Forward (training, evaluation)
# ---------------------------------------------------------------------------

def layer_slice(tree: Dict, index: int) -> Dict:
    """{name: {key: (L, ...) tensor}} -> the layer-``index`` views."""
    return {t: {k: v[index] for k, v in leaf.items()}
            for t, leaf in tree.items()}


def layer_forward(x: torch.Tensor, lp: Dict, ad: LoraTree, cfg: ModelConfig,
                  *, causal: bool, positions: torch.Tensor) -> torch.Tensor:
    """Pre-norm block over a whole sequence. x: (B, S, d)."""
    q, k, v = qkv_proj(norm(x, lp["ln1"]), lp["attn"], cfg, ad)
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=causal, window=cfg.sliding_window)
    x = x + out_proj(o, lp["attn"], cfg, ad)
    return x + mlp(norm(x, lp["ln2"]), lp["mlp"], cfg, ad)


def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig, *,
            causal: bool = True) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, V), or (B, C) for a classifier
    (CLS pooling: the final norm of position 0). Differentiable in
    ``params.lora`` and ``params.cls``; attention is the plain masked
    softmax, as in the reference's training path."""
    b, s = tokens.shape
    x = params.embed[tokens.long()]                          # (B, S, d)
    positions = torch.arange(s, device=x.device)[None, :]
    if cfg.rope_theta == 0:
        # content scaled up so absolute positions don't swamp it
        x = x * math.sqrt(cfg.d_model) + sinusoidal_positions(
            positions, cfg.d_model).to(x.dtype)
    for layer in range(cfg.num_layers):
        x = layer_forward(x, params.layer(layer),
                          layer_slice(params.lora, layer), cfg,
                          causal=causal, positions=positions)
    x = norm(x, params.final_norm.as_dict())
    if cfg.num_classes:
        return x[:, 0, :] @ params.cls["cls_head"] + params.cls["cls_bias"]
    return x @ params.head()


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    return init_kv_cache(cfg.num_layers, batch, max_seq, cfg.num_kv_heads,
                         cfg.resolved_head_dim, window=cfg.sliding_window,
                         dtype=dtype, device=device)


def layer_decode(x: torch.Tensor, lp: Dict, ad: LoraTree,
                 lc: Dict[str, torch.Tensor], pos: int, cfg: ModelConfig):
    """One token through one layer with cache. x: (B, 1, d)."""
    h = norm(x, lp["ln1"])
    q, k, v = qkv_proj(h, lp["attn"], cfg, ad)
    if cfg.rope_theta > 0:
        pvec = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
        q = rope(q, pvec, cfg.rope_theta)
        k = rope(k, pvec, cfg.rope_theta)
    lc = cache_insert(lc, k, v, pos)
    o = attention(q, lc["k"], lc["v"], causal=True,
                  window=cfg.sliding_window, q_offset=pos,
                  kv_positions=lc["pos"], kv_valid=lc["pos"] >= 0)
    x = x + out_proj(o, lp["attn"], cfg, ad)
    return x + mlp(norm(x, lp["ln2"]), lp["mlp"], cfg, ad), lc


@torch.no_grad()
def decode_step(params: Transformer, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos: int, cfg: ModelConfig):
    """token: (B, 1) int, pos: absolute position. Returns (logits (B, V),
    cache); the cache is updated in place."""
    x = params.embed[token]                                  # (B, 1, d)
    if cfg.rope_theta == 0:
        x = x * math.sqrt(cfg.d_model) + sinusoidal_positions(
            torch.full((1, 1), pos, device=x.device), cfg.d_model
        ).to(x.dtype)
    for layer in range(cfg.num_layers):
        lc = {n: c[layer] for n, c in cache.items()}
        x, _ = layer_decode(x, params.layer(layer),
                            layer_slice(params.lora, layer), lc, pos, cfg)
    x = norm(x, params.final_norm.as_dict())
    return x[:, 0, :] @ params.head(), cache
