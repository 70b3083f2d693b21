"""Shared model building blocks (port of ``repro/models/common.py``):
norms, positions, RoPE, masked attention, MLP, LoRA-wrapped projections
and KV caches. Plain functions on tensors; layouts follow the reference
(``(B, S, H, Dh)`` heads, ``(d_in, d_out)`` weights)."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import Adapter, apply_lora
from repro_torch.kernels.paged_attn import NEG_INF

# ---------------------------------------------------------------------------
# Norms & positions
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """Gemma-style RMS norm: scales by ``(1 + w)``, in float32."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def sinusoidal_positions(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """(...,) int positions -> (..., dim) sinusoidal embedding."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, device=positions.device)
                      / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding with the half-split rotation.
    x: (B, S, H, Dh), positions: (B, S) or (S,)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs           # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d).reshape(
        b, s, h * groups, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset=0, kv_positions: Optional[torch.Tensor] = None,
              kv_valid: Optional[torch.Tensor] = None,
              q_chunk: int = 1024) -> torch.Tensor:
    """Masked softmax attention. q: (B, Sq, H, Dh), k/v: (B, Skv, Hkv, Dh);
    ``q_offset`` is the absolute position of q[0]; ``kv_positions`` (B, Skv)
    the keys' absolute positions (default 0..Skv-1); ``kv_valid`` (B, Skv)
    an extra validity mask. Queries are attended in chunks of ``q_chunk``
    (the largest divisor of Sq that fits, as in the reference), each at its
    absolute positions, so the scores take O(chunk · Skv) memory at once;
    the chunking changes no value."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    if kv_positions is None:
        kv_pos = torch.arange(skv, device=q.device)[None, :].expand(b, skv)
    else:
        kv_pos = kv_positions

    def attend_chunk(qc: torch.Tensor, qpos: torch.Tensor) -> torch.Tensor:
        # qc: (B, C, H, Dh); qpos: (C,) absolute positions
        logits = torch.einsum("bchd,bshd->bhcs", qc.float(), k.float()) * scale
        mask = torch.ones((b, qc.shape[1], skv), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kv_pos[:, None, :] <= qpos[None, :, None]
        if window is not None:
            mask &= kv_pos[:, None, :] > (qpos[None, :, None] - window)
        if kv_valid is not None:
            mask &= kv_valid[:, None, :]
        logits = torch.where(mask[:, None, :, :], logits,
                             torch.full_like(logits, NEG_INF))
        p = torch.softmax(logits, dim=-1)
        return torch.einsum("bhcs,bshd->bchd", p.to(v.dtype), v)

    pos = torch.arange(sq, device=q.device)
    if sq <= q_chunk:
        return attend_chunk(q, q_offset + pos)
    if sq % q_chunk:  # the largest divisor of sq that fits
        q_chunk = max(c for c in range(1, q_chunk + 1) if sq % c == 0)
    return torch.cat([attend_chunk(q[:, i:i + q_chunk],
                                   q_offset + pos[i:i + q_chunk])
                      for i in range(0, sq, q_chunk)], dim=1)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def init_kv_cache(num_layers: int, batch: int, max_seq: int, kv_heads: int,
                  head_dim: int, window: Optional[int] = None,
                  dtype=torch.bfloat16, device=None
                  ) -> Dict[str, torch.Tensor]:
    """Full cache (window=None) or ring buffer of W slots; ``pos`` holds
    each slot's absolute position, -1 = empty. Stacked over layers."""
    slots = max_seq if window is None else min(window, max_seq)
    shape = (num_layers, batch, slots, kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((num_layers, batch, slots), -1, dtype=torch.int32,
                          device=device),
    }


def init_paged_kv_pool(num_layers: int, num_pages: int, page_size: int,
                       kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                       device=None) -> Dict[str, torch.Tensor]:
    """Global paged KV pool (``serve/pages.py``). Page ``num_pages`` is the
    trash page: writes for padded or inactive tokens land there, so no
    live page is corrupted. A slot's absolute position is implicit in the
    page table (slot s of a row's j-th page is position j*page_size + s)."""
    shape = (num_layers, num_pages + 1, page_size, kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_insert(layer_cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                 v_new: torch.Tensor, pos: int) -> Dict[str, torch.Tensor]:
    """Insert one token (B, 1, Hkv, Dh) at absolute position ``pos``. The
    reference rebuilds the arrays; here the slot is written in place."""
    slot = pos % layer_cache["k"].shape[1]
    layer_cache["k"][:, slot] = k_new[:, 0]
    layer_cache["v"][:, slot] = v_new[:, 0]
    layer_cache["pos"][:, slot] = pos
    return layer_cache


# ---------------------------------------------------------------------------
# MLP / projections
# ---------------------------------------------------------------------------

def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's to erf.
    return F.gelu(x, approximate="tanh")


def _act(name: str):
    return {"silu": F.silu, "geglu": _gelu_tanh, "gelu": _gelu_tanh}[name]


def mlp(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
        adapters: Optional[Dict[str, Adapter]] = None) -> torch.Tensor:
    """Gated (silu/geglu) or plain (gelu) MLP; optional LoRA on w1/w2/w3."""
    ad = adapters or {}
    alpha = cfg.lora.alpha
    h = apply_lora(x, p["w1"], ad.get("w1"), alpha)
    if cfg.use_bias and "b1" in p:
        h = h + p["b1"]
    h = _act(cfg.activation)(h)
    if "w3" in p:  # gated
        h = h * apply_lora(x, p["w3"], ad.get("w3"), alpha)
    out = apply_lora(h, p["w2"], ad.get("w2"), alpha)
    if cfg.use_bias and "b2" in p:
        out = out + p["b2"]
    return out


def qkv_proj(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
             adapters: Optional[Dict[str, Adapter]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    ad = adapters or {}
    alpha = cfg.lora.alpha
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = apply_lora(x, p["wq"], ad.get("q"), alpha)
    k = apply_lora(x, p["wk"], ad.get("k"), alpha)
    v = apply_lora(x, p["wv"], ad.get("v"), alpha)
    if cfg.use_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, cfg.num_heads, hd),
            k.reshape(b, s, cfg.num_kv_heads, hd),
            v.reshape(b, s, cfg.num_kv_heads, hd))


def out_proj(attn_out: torch.Tensor, p: Dict[str, torch.Tensor],
             cfg: ModelConfig, adapters: Optional[Dict[str, Adapter]] = None
             ) -> torch.Tensor:
    b, s, h, dh = attn_out.shape
    ad = adapters or {}
    y = apply_lora(attn_out.reshape(b, s, h * dh), p["wo"], ad.get("o"),
                   cfg.lora.alpha)
    if cfg.use_bias and "bo" in p:
        y = y + p["bo"]
    return y
