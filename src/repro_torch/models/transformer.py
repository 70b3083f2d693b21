"""Decoder-only transformer (port of ``repro/models/transformer.py``): the
dense and mixture-of-experts decoders (``layers["mlp"]`` holds the MoE
FFN's router and experts when ``num_experts`` is set, ``models/moe.py``),
and the RoBERTa-style encoder classifier (``causal=False``, CLS pooling, a
``cls_head``). The module class also holds the attention-free Mamba2 stack
(``layers`` = {"ln1", "ssm"}, ``models/mamba2.py``), whose forward and
decode live in ``models/model.py``, the Hymba hybrid (``layers`` =
{"ln1", "attn", "ssm", "ln2", "mlp"}, ``models/hymba.py``) and Whisper's
encoder-decoder (``encoder`` = {"ln1", "attn", "ln2", "mlp"} stacked over
the encoder's layers and ``enc_norm`` beside the decoder's ``layers`` =
{"ln1", "attn", "lnx", "xattn", "ln2", "mlp"}, ``models/whisper.py``):
``Transformer`` takes its layer groups from the tree it is given.

The model is an ``nn.Module`` whose parameters keep the reference's
stacked layout: every per-layer weight is one ``(L, ...)`` tensor and
projections are ``(d_in, d_out)``, so ``x @ W0`` is the same product on
both sides and ``interop.py`` moves weights across one to one. The
reference's ``lax.scan`` over layers becomes a Python loop over
per-layer views (``unbind_layers`` in training and evaluation,
``Transformer.layer(l)`` in decode).

``Transformer.lora`` is the reference's ``params["lora"]``:
``{target: {"A": (L, d_in, r), "B": (L, r, d_out), "mask": (L, r)}}``;
``Transformer.cls`` holds a classifier's ``cls_head`` (d, C) and
``cls_bias`` (C,) (empty otherwise). Both are plain dicts of tensors, so a
trainer can put leaves that require grad in their place (``fed/client``).
Every weight is wrapped frozen; backbone pretraining differentiates a
fresh module built from :meth:`Transformer.tree` whose own Parameters it
sets to require grad (``fed/simulation.py``), and rebuilds the updated
module with :meth:`Transformer.from_tree`.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import lora as lora_lib
from repro_torch.device import resolve_device
from repro_torch.models import moe as moe_lib
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
    """Decoder or encoder: ``embed`` (V, d), stacked ``layers`` groups
    (``ln1``/``attn``/``ln2``/``mlp`` for the transformer families,
    ``ln1``/``ssm`` for Mamba2, both sets for Hymba, ``lnx``/``xattn``
    added for Whisper's decoder), ``final_norm``, optional ``lm_head``
    (d, V) (tied to ``embed`` otherwise), for classifiers ``cls`` =
    {``cls_head`` (d, C), ``cls_bias`` (C,)}, and for an encoder-decoder
    the stacked ``encoder`` groups and ``enc_norm`` (None otherwise)."""

    # the transformer families' groups, in the order the module keeps them
    # (any other group of the tree, Mamba2's and Hymba's ssm, Whisper's lnx
    # and xattn, follows; every reader takes a group by name)
    GROUPS = ("ln1", "attn", "ln2", "mlp")

    def __init__(self, cfg: ModelConfig, tree: Dict, lora: LoraTree):
        super().__init__()
        self.cfg = cfg
        self.embed = _frozen(tree["embed"])
        given = tree["layers"]
        self.groups = tuple([g for g in self.GROUPS if g in given]
                            + [g for g in given if g not in self.GROUPS])
        self.layers = nn.ModuleDict(
            {g: ParamGroup(given[g]) for g in self.groups})
        enc = tree.get("encoder")
        self.encoder = (None if enc is None else nn.ModuleDict(
            {g: ParamGroup(grp) for g, grp in enc.items()}))
        self.enc_norm = (ParamGroup(tree["enc_norm"]) if "enc_norm" in tree
                         else None)
        self.final_norm = ParamGroup(tree["final_norm"])
        self.lm_head = (_frozen(tree["lm_head"]) if "lm_head" in tree
                        else None)
        self.lora = lora
        self.cls = {k: tree[k] for k in HEAD_KEYS if k in tree}

    def layer(self, index: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Layer ``index`` as the reference's per-layer param dict
        (views, no copies)."""
        return {g: self.layers[g].as_dict(index) for g in self.groups}

    def head(self) -> torch.Tensor:
        return self.lm_head if self.lm_head is not None else self.embed.T

    def encoder_groups(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The encoder's stacked groups as the reference's dicts."""
        return {g: grp.as_dict() for g, grp in self.encoder.items()}

    def tree(self) -> Dict:
        """Every tensor in the reference's ``params`` layout: ``embed``,
        ``encoder`` and ``enc_norm`` (encoder-decoders), ``layers``,
        ``final_norm``, ``lm_head`` (untied decoders), ``cls_head`` and
        ``cls_bias`` (classifiers) and ``lora``. The weights are this
        module's own Parameters, so a gradient taken with respect to them
        is one of the module's forward."""
        tree = {"embed": self.embed}
        if self.encoder is not None:
            tree["encoder"] = self.encoder_groups()
            tree["enc_norm"] = self.enc_norm.as_dict()
        tree.update(final_norm=self.final_norm.as_dict(),
                    layers={g: self.layers[g].as_dict()
                            for g in self.groups},
                    **self.cls, lora=self.lora)
        if self.lm_head is not None:
            tree["lm_head"] = self.lm_head
        return tree

    @classmethod
    def from_tree(cls, cfg: ModelConfig, tree: Dict) -> "Transformer":
        """The way back from :meth:`tree`: a frozen module wrapping the
        tree's tensors (no copies)."""
        return cls(cfg, tree, tree["lora"])

    def to_device(self, device) -> "Transformer":
        """A copy with every tensor (weights, adapters, head) on
        ``device``, e.g. the same weights on the CPU and on the card."""
        def move(node):
            if isinstance(node, dict):
                return {k: move(v) for k, v in node.items()}
            return node.detach().to(device)

        return Transformer.from_tree(self.cfg, move(self.tree()))

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
    """{target: (d_in, d_out)} for every configured LoRA target; Mamba2's
    ``ssm_in`` is x -> [z, x, B, C, dt], ``ssm_out`` d_inner -> d."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dims = {"q": (d, cfg.num_heads * hd), "k": (d, cfg.num_kv_heads * hd),
            "v": (d, cfg.num_kv_heads * hd), "o": (cfg.num_heads * hd, d),
            "w1": (d, cfg.d_ff), "w3": (d, cfg.d_ff), "w2": (cfg.d_ff, d),
            "ssm_in": (d, 2 * cfg.d_inner + 2 * cfg.ssm_state
                       + cfg.ssm_heads),
            "ssm_out": (cfg.d_inner, d)}
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
    weights, ``init_moe_params``' for a MoE FFN); not the same numbers,
    since the generators differ."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    tree, lora = init_tree(gen, cfg, dtype)
    return Transformer(cfg, tree, lora)


def _dense(gen: torch.Generator, dtype, *shape) -> torch.Tensor:
    """Normal draws from ``gen`` on its device, scaled by 1/sqrt(d_in)."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(1.0 / math.sqrt(shape[-2])).to(dtype)


def init_norm(shape, use_bias: bool, dtype, device) -> Dict:
    """Zero RMS norm weights, or a layer norm's ones and zero bias under
    ``use_bias``."""
    p = {"w": torch.zeros(shape, dtype=dtype, device=device)}
    if use_bias:
        p["w"] += 1.0
        p["b"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def init_attn(gen: torch.Generator, cfg: ModelConfig, L: int, dtype
              ) -> Dict[str, torch.Tensor]:
    """``wq``, ``wk``, ``wv``, ``wo`` stacked over ``L`` layers, drawn from
    ``gen`` in that order, and zero biases under ``use_bias``."""
    d, hd, dev = cfg.d_model, cfg.resolved_head_dim, gen.device
    attn = {"wq": _dense(gen, dtype, L, d, cfg.num_heads * hd),
            "wk": _dense(gen, dtype, L, d, cfg.num_kv_heads * hd),
            "wv": _dense(gen, dtype, L, d, cfg.num_kv_heads * hd),
            "wo": _dense(gen, dtype, L, cfg.num_heads * hd, d)}
    if cfg.use_bias:
        for n, width in (("bq", cfg.num_heads * hd),
                         ("bk", cfg.num_kv_heads * hd),
                         ("bv", cfg.num_kv_heads * hd), ("bo", d)):
            attn[n] = torch.zeros((L, width), dtype=dtype, device=dev)
    return attn


def init_mlp(gen: torch.Generator, cfg: ModelConfig, L: int, dtype
             ) -> Dict[str, torch.Tensor]:
    """A dense MLP's ``w1``, ``w2`` (and ``w3`` when gated) stacked over
    ``L`` layers, and zero biases under ``use_bias``."""
    d, ff, dev = cfg.d_model, cfg.d_ff, gen.device
    mlp_p = {"w1": _dense(gen, dtype, L, d, ff),
             "w2": _dense(gen, dtype, L, ff, d)}
    if cfg.activation in ("silu", "geglu"):
        mlp_p["w3"] = _dense(gen, dtype, L, d, ff)
    if cfg.use_bias:
        mlp_p["b1"] = torch.zeros((L, ff), dtype=dtype, device=dev)
        mlp_p["b2"] = torch.zeros((L, d), dtype=dtype, device=dev)
    return mlp_p


def init_embed(gen: torch.Generator, cfg: ModelConfig, dtype
               ) -> torch.Tensor:
    return torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                       dtype=torch.float32, device=gen.device
                       ).mul_(0.02).to(dtype)


def init_tree(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32
              ) -> Tuple[Dict, LoraTree]:
    """``init_params``' draws from ``gen``, on its device: (the weight
    tree, the adapters), for a caller that adds groups of its own (Hymba's
    ``ssm``) from the same generator."""
    dev = gen.device
    L, d = cfg.num_layers, cfg.d_model
    attn = init_attn(gen, cfg, L, dtype)
    if cfg.num_experts:
        mlp_p = moe_lib.init_moe_params(gen, cfg, L, dtype, dev)
        if cfg.use_bias:
            mlp_p["b1"] = torch.zeros((L, cfg.d_ff), dtype=dtype, device=dev)
            mlp_p["b2"] = torch.zeros((L, d), dtype=dtype, device=dev)
    else:
        mlp_p = init_mlp(gen, cfg, L, dtype)
    embed = init_embed(gen, cfg, dtype)
    tree = {"embed": embed,
            "layers": {"ln1": init_norm((L, d), cfg.use_bias, dtype, dev),
                       "attn": attn,
                       "ln2": init_norm((L, d), cfg.use_bias, dtype, dev),
                       "mlp": mlp_p},
            "final_norm": init_norm((d,), cfg.use_bias, dtype, dev)}
    lora = init_lora(gen, cfg, device=dev)
    if cfg.num_classes:
        tree["cls_head"] = _dense(gen, dtype, d, cfg.num_classes)
        tree["cls_bias"] = torch.zeros((cfg.num_classes,), dtype=dtype,
                                       device=dev)
    elif not cfg.tie_embeddings:
        tree["lm_head"] = _dense(gen, dtype, d, cfg.vocab_size)
    return tree, lora


# ---------------------------------------------------------------------------
# Forward (training, evaluation)
# ---------------------------------------------------------------------------

def layer_slice(tree: Dict, index: int) -> Dict:
    """{name: {key: (L, ...) tensor}} -> the layer-``index`` views."""
    return {t: {k: v[index] for k, v in leaf.items()}
            for t, leaf in tree.items()}


def unbind_layers(tree: Dict, num_layers: int) -> List[Dict]:
    """{name: {key: (L, ...) tensor}} -> every layer's views, each stacked
    tensor unbound once. Autograd then gathers a trainable stack's
    per-layer gradients with one stack, where ``layer_slice``'s index
    views would each add a zero-filled (L, ...) gradient: L^2 traffic."""
    cols = {t: {k: v.unbind(0) for k, v in leaf.items()}
            for t, leaf in tree.items()}
    return [{t: {k: v[i] for k, v in leaf.items()} for t, leaf in cols.items()}
            for i in range(num_layers)]


def ffn(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
        ad: LoraTree) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's FFN: (y, aux), aux the MoE load-balance loss (a float32
    zero for a dense MLP)."""
    if cfg.num_experts:
        return moe_lib.moe_ffn(x, p, cfg, ad)
    return mlp(x, p, cfg, ad), torch.zeros((), dtype=torch.float32,
                                           device=x.device)


def layer_forward(x: torch.Tensor, lp: Dict, ad: LoraTree, cfg: ModelConfig,
                  *, causal: bool, positions: torch.Tensor,
                  q_chunk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm block over a whole sequence. x: (B, S, d) -> (x, aux)."""
    q, k, v = qkv_proj(norm(x, lp["ln1"]), lp["attn"], cfg, ad)
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=causal, window=cfg.sliding_window,
                  q_chunk=q_chunk)
    x = x + out_proj(o, lp["attn"], cfg, ad)
    y, aux = ffn(norm(x, lp["ln2"]), lp["mlp"], cfg, ad)
    return x + y, aux


def run_layers(params: Transformer, x: torch.Tensor, cfg: ModelConfig,
               layer, remat: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """x through every layer of ``params``: ``layer(x, lp, ad) -> (x,
    aux)`` on each layer's views of the stacked weights and adapters, with
    ``remat`` under ``torch.utils.checkpoint`` where autograd records.
    Returns (x, the layers' aux summed)."""
    stacked = {g: params.layers[g].as_dict() for g in params.groups}
    auxs = []
    for lp, ad in zip(unbind_layers(stacked, cfg.num_layers),
                      unbind_layers(params.lora, cfg.num_layers)):
        if remat and torch.is_grad_enabled():
            # non-reentrant: the reentrant form does not support
            # torch.autograd.grad, which the trainers take
            x, aux = torch.utils.checkpoint.checkpoint(layer, x, lp, ad,
                                                       use_reentrant=False)
        else:
            x, aux = layer(x, lp, ad)
        auxs.append(aux)
    return x, torch.stack(auxs).sum()


def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig, *,
            remat: bool = True, q_chunk: int = 1024,
            causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int -> (logits (B, S, V), or (B, C) for a classifier
    (CLS pooling: the final norm of position 0); aux, the layers' MoE
    load-balance losses summed, float32). Differentiable in
    every tensor of ``params`` that requires grad; attention is the plain
    masked softmax in query chunks of ``q_chunk``, as in the reference's
    training path. With ``remat`` (the reference's ``jax.checkpoint`` per
    layer) a layer keeps only its input for the backward, which runs the
    layer again; it changes memory and time, never values."""
    b, s = tokens.shape
    x = params.embed[tokens.long()]                          # (B, S, d)
    positions = torch.arange(s, device=x.device)[None, :]
    if cfg.rope_theta == 0:
        # content scaled up so absolute positions don't swamp it
        x = x * math.sqrt(cfg.d_model) + sinusoidal_positions(
            positions, cfg.d_model).to(x.dtype)

    def layer(x, lp, ad):
        return layer_forward(x, lp, ad, cfg, causal=causal,
                             positions=positions, q_chunk=q_chunk)

    x, aux = run_layers(params, x, cfg, layer, remat)
    x = norm(x, params.final_norm.as_dict())
    if cfg.num_classes:
        return (x[:, 0, :] @ params.cls["cls_head"] + params.cls["cls_bias"],
                aux)
    return x @ params.head(), aux


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
    y, _ = ffn(norm(x, lp["ln2"]), lp["mlp"], cfg, ad)   # aux dropped
    return x + y, lc


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
