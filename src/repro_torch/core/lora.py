"""LoRA adapters with static-shape heterogeneous ranks (port of
``repro/core/lora.py``).

Row-vector convention ``y = x @ W`` with ``W: (d_in, d_out)``; an adapter
is ``{"A": (..., d_in, r_max), "B": (..., r_max, d_out), "mask": (...,
r_max)}`` with ``mask[i] = 1`` iff ``i < rank``. Masked directions add
exactly zero to ``ΔW = (A·m) @ (B·m)``, and the scale is
``alpha / max(Σ mask, 1)``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

Adapter = Dict[str, torch.Tensor]  # {"A", "B", "mask"}


def make_rank_mask(rank: int, r_max: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """mask[i] = 1. iff i < rank."""
    return (torch.arange(r_max, device=device) < rank).to(dtype)


def init_adapter(gen: torch.Generator, d_in: int, d_out: int, r_max: int,
                 rank: Optional[int] = None,
                 stack_dims: Tuple[int, ...] = (), dtype=torch.float32,
                 device=None) -> Adapter:
    """One adapter: gaussian input factor (std 1/sqrt(d_in)), zero output
    factor, so ΔW = 0 at t=0. ``gen`` must live on ``device``."""
    rank = r_max if rank is None else rank
    a = torch.randn((*stack_dims, d_in, r_max), generator=gen, dtype=dtype,
                    device=device) / math.sqrt(d_in)
    b = torch.zeros((*stack_dims, r_max, d_out), dtype=dtype, device=device)
    mask = make_rank_mask(rank, r_max, dtype, device).expand(
        *stack_dims, r_max).clone()
    return {"A": a, "B": b, "mask": mask}


def tree_init(gen: torch.Generator, specs: Dict[str, Tuple[int, int]],
              r_max: int, rank: Optional[int] = None,
              stack_dims_map: Optional[Dict[str, Tuple[int, ...]]] = None,
              dtype=torch.float32, device=None) -> Dict[str, Adapter]:
    """Adapters for {target: (d_in, d_out)}, drawn in sorted target order."""
    out = {}
    for name, (d_in, d_out) in sorted(specs.items()):
        stack = (stack_dims_map or {}).get(name, ())
        out[name] = init_adapter(gen, d_in, d_out, r_max, rank, stack, dtype,
                                 device)
    return out


def lora_scale(adapter: Adapter, alpha: float) -> torch.Tensor:
    return alpha / torch.clamp(adapter["mask"].sum(-1), min=1.0)


def masked_factors(adapter: Adapter) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A·mask, B·mask)."""
    m = adapter["mask"]
    return adapter["A"] * m[..., None, :], adapter["B"] * m[..., :, None]


def delta_w(adapter: Adapter, alpha: float) -> torch.Tensor:
    """ΔW = scale · (A·m) @ (B·m)."""
    a, b = masked_factors(adapter)
    return lora_scale(adapter, alpha)[..., None, None] * (a @ b)


def apply_lora(x: torch.Tensor, w0: torch.Tensor, adapter: Optional[Adapter],
               alpha: float) -> torch.Tensor:
    """y = x @ W0 + scale · (x @ A·m) @ (B·m); the adapter path computes in
    x.dtype, as the reference does."""
    y = x @ w0
    if adapter is None:
        return y
    a, b = masked_factors(adapter)
    lo = (x @ a.to(x.dtype)) @ b.to(x.dtype)
    sc = lora_scale(adapter, alpha).to(lo.dtype)
    if sc.ndim:
        sc = sc[..., None, None]
    return y + (sc * lo).to(y.dtype)


def merge(w0: torch.Tensor, adapter: Adapter, alpha: float) -> torch.Tensor:
    """Fold the adapter into the base weights (deployment path)."""
    return w0 + delta_w(adapter, alpha).to(w0.dtype)
