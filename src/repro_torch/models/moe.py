"""Mixture-of-experts FFN (port of ``repro/models/moe.py``).

The reference dispatches with a one-hot ``(G, g·k, E, c)`` tensor and two
dense contractions. A one-hot contraction picks exactly one term, so the
same numbers come from a permutation: each token is repeated k times, each
kept (token, slot) row is written to its own (expert, position) row of an
``(E, G·c, d)`` buffer (dropped rows all go to one spare row, which is then
discarded), the experts run as one batched product over all E, and the
combine writes each buffer row back to its slot (empty rows to a spare
slot), scales the slots by their gates and sums the k slots in slot order.
Both moves are writes to distinct rows, whose backward is a gather, so
neither direction adds two values into one place: no atomics on the card,
the same bits from run to run. At g = 1024 and c = 160 (OLMoE-1B-7B) the
one-hot tensor would take 335 MB a group and ~2 x 172 GFLOP a layer.

Routing as in the reference: the router runs in float32; softmax, then the
top-k probabilities renormalised to sum to 1 (ties to the lower expert
index, as ``jax.lax.top_k``: a stable descending sort); the Switch load
balance loss E · Σ_e mean-prob_e · (top-k share)_e, the share counted
before capacity drops; capacity c = max(1, ceil(g·k·cf / E)); a slot's
position in its expert counts the slots before it in the group's
token-major (token, slot) order, and a slot at position >= c is dropped:
its gate becomes 0 and the token's other gates stay as they were.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import Adapter, apply_lora


class Routing(NamedTuple):
    """One call's routing over G groups of g tokens (k slots a token)."""
    top_idx: torch.Tensor   # (G, g, k) int64: each slot's expert
    gates: torch.Tensor     # (G, g·k) float32: renormalised top-k, 0 dropped
    keep: torch.Tensor      # (G, g·k) bool: position < capacity
    dest: torch.Tensor      # (G·g·k,) int64: buffer row; E·G·c if dropped
    aux: torch.Tensor       # () float32: the load-balance loss
    capacity: int


def group_size(cfg: ModelConfig, tokens: int) -> int:
    """min(moe_group_size, tokens); raises unless it divides ``tokens``."""
    g = min(cfg.moe_group_size, tokens)
    if tokens % g:
        raise ValueError(f"tokens {tokens} not divisible by group size {g}")
    return g


def capacity(cfg: ModelConfig, g: int) -> int:
    return max(1, int(math.ceil(g * cfg.experts_per_token
                                * cfg.moe_capacity_factor
                                / cfg.num_experts)))


def route(xg: torch.Tensor, router: torch.Tensor, cfg: ModelConfig
          ) -> Routing:
    """Routing of xg (G, g, d) through router (d, E)."""
    n_groups, g, _ = xg.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = capacity(cfg, g)
    logits = torch.matmul(xg.float(), router.float())          # (G, g, E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k takes the lower index on a tie; torch.topk promises no
    # order, a stable descending sort keeps the lower index first
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_idx = srt[..., :k], order[..., :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    oh = F.one_hot(top_idx, e)                                 # (G, g, k, E)
    me = probs.mean(dim=(0, 1))
    ce = oh.sum(2).float().mean(dim=(0, 1)) / k
    aux = e * torch.sum(me * ce)
    ohf = oh.reshape(n_groups, g * k, e)
    # each slot's position inside its expert: the slots before it there,
    # a running count scanned with the slots innermost (along the outer
    # dim the card's scan runs one thread an expert over all g·k slots)
    seen = torch.cumsum(ohf.transpose(1, 2).contiguous(), dim=-1)
    pos = ((seen.transpose(1, 2) - ohf) * ohf).sum(-1)         # (G, g·k)
    keep = pos < cap
    gates = top_p.reshape(n_groups, g * k) * keep
    group = torch.arange(n_groups, device=xg.device)[:, None]
    dest = (top_idx.reshape(n_groups, g * k) * (n_groups * cap)
            + group * cap + pos)
    dest = torch.where(keep, dest, torch.full_like(dest, e * n_groups * cap))
    return Routing(top_idx, gates, keep, dest.reshape(-1), aux, cap)


def moe_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
            adapters: Optional[Dict[str, Adapter]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux float32 scalar). ``p`` holds one
    layer's ``router`` (d, E), ``we1``/``we3`` (E, d, ff), ``we2`` (E, ff,
    d) and, with ``moe_shared``, the shared expert's ``w1``/``w3`` (d,
    d_ff) and ``w2`` (d_ff, d), which take ``adapters``' w1/w3/w2."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    g = group_size(cfg, t)
    n_groups = t // g
    xg = x.reshape(n_groups, g, d)
    r = route(xg, p["router"], cfg)
    rows = e * n_groups * r.capacity
    # each token k times, token-major; an expand, whose backward sums the
    # k copies in one reduction (repeat_interleave's index_add would add
    # them with atomics on the card)
    xk = xg[:, :, None, :].expand(n_groups, g, k, d).reshape(-1, d)
    buf = x.new_zeros(rows + 1, d).index_put((r.dest,), xk)
    xe = buf[:rows].view(e, n_groups * r.capacity, d)
    # one batched product over every expert: an empty expert's rows are
    # zeros, and every weight stays in the graph
    h = F.silu(torch.matmul(xe, p["we1"])) * torch.matmul(xe, p["we3"])
    ye = torch.matmul(h, p["we2"]).reshape(rows, d)
    # the combine writes each buffer row back to its slot (empty rows to
    # a spare slot, discarded): a write whose backward is a gather, where
    # gathering the rows would take a sorted scatter-add backward
    slots = r.dest.numel()
    src = torch.full((rows + 1,), slots, dtype=r.dest.dtype,
                     device=x.device).index_put_(
        (r.dest,), torch.arange(slots, device=x.device))
    y = x.new_zeros(slots + 1, d).index_put((src[:rows],), ye)[:slots]
    y = y * r.gates.reshape(-1, 1).to(x.dtype)
    y = y.view(n_groups, g, k, d).sum(dim=2).reshape(b, s, d)
    if cfg.moe_shared:  # llama4: the always-on shared expert
        ad = adapters or {}
        alpha = cfg.lora.alpha
        hs = F.silu(apply_lora(x, p["w1"], ad.get("w1"), alpha))
        hs = hs * apply_lora(x, p["w3"], ad.get("w3"), alpha)
        y = y + apply_lora(hs, p["w2"], ad.get("w2"), alpha)
    return y, r.aux.float()


def init_moe_params(gen: torch.Generator, cfg: ModelConfig, num_layers: int,
                    dtype=torch.float32, device=None
                    ) -> Dict[str, torch.Tensor]:
    """Stacked (L, ...) MoE FFN weights from ``gen`` (on ``device``), with
    the reference's distributions: router, we1 and we3 std 1/sqrt(d), we2
    std 1/sqrt(ff); the shared expert's w1 and w3 std 1/sqrt(d), w2
    1/sqrt(d_ff)."""
    d, e = cfg.d_model, cfg.num_experts
    ff = cfg.moe_d_ff or cfg.d_ff

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return w.mul_(std).to(dtype)

    std_d, std_f = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    p = {"router": normal((num_layers, d, e), std_d),
         "we1": normal((num_layers, e, d, ff), std_d),
         "we3": normal((num_layers, e, d, ff), std_d),
         "we2": normal((num_layers, e, ff, d), std_f)}
    if cfg.moe_shared:
        sf = cfg.d_ff
        p["w1"] = normal((num_layers, d, sf), std_d)
        p["w3"] = normal((num_layers, d, sf), std_d)
        p["w2"] = normal((num_layers, sf, d), 1.0 / math.sqrt(sf))
    return p
