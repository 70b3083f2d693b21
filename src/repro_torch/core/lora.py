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

from repro_torch.kernels import ops

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
    """alpha / max(Σ mask, 1). ``torch.maximum`` (not ``clamp``) so that a
    trained mask summing to exactly 1 splits its gradient between the two
    sides as ``jnp.maximum`` does."""
    r_eff = adapter["mask"].sum(-1)
    return alpha / torch.maximum(r_eff, r_eff.new_ones(()))


def masked_factors(adapter: Adapter) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A·mask, B·mask)."""
    m = adapter["mask"]
    return adapter["A"] * m[..., None, :], adapter["B"] * m[..., :, None]


def delta_w(adapter: Adapter, alpha: float) -> torch.Tensor:
    """ΔW = scale · (A·m) @ (B·m)."""
    a, b = masked_factors(adapter)
    return lora_scale(adapter, alpha)[..., None, None] * (a @ b)


class _LoraMatmul(torch.autograd.Function):
    """y = x @ W0 + s (x @ A) @ B over 2-D x (M, K) and masked factors,
    differentiable in x, A and B through ``ops``' backward (the CUDA
    kernels on the card, their plain versions on the CPU), and in W0 and
    the scale where they require grad (backbone pretraining): dW0 = x^T dy
    is one float32 product (cuBLAS on the card, as every unadapted
    projection's weight gradient), and ds = Σ xa * g from the bottleneck
    and the dx op's unscaled g = dy B^T. Masking happens outside, so
    autograd's mask product gives masked rank directions exactly zero
    gradient, and carries dA, dB and ds on into the mask."""

    @staticmethod
    def forward(ctx, x, w0, a, b, scale):
        y, xa = ops.lora_matmul(x, w0, a, b, scale, return_xa=True)
        ctx.save_for_backward(x, w0, a, b, scale, xa)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w0, a, b, scale, xa = ctx.saved_tensors
        need_x, need_w0, need_a, need_b, need_s = ctx.needs_input_grad
        dy = dy.contiguous()
        # g = dy @ B^T always; dx only where x needs it (not at layer 0
        # of client training, whose input is the norm of the frozen
        # embedding)
        dx, g = ops.lora_matmul_dx(dy, w0, a, b, scale, need_dx=need_x)
        da = db = dw0 = ds = None
        if need_a or need_b:
            da, db = ops.lora_matmul_grad_ab(x, xa, dy, g, scale)
        if need_w0:
            dw0 = torch.matmul(x.t(), dy).to(w0.dtype)
        if need_s:
            ds = (xa * g).sum().reshape(scale.shape)
        return dx, dw0, da, db, ds


def _lora_2d(x: torch.Tensor, w0: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """One adapter (a (d_in, r), b (r, d_out), scalar sc) on x (..., d_in):
    leading dims flattened to rows, one fused call."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    w0 = w0.contiguous()
    a, b = a.to(x.dtype).contiguous(), b.to(x.dtype).contiguous()
    sc = sc.to(torch.float32)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w0, a, b, sc)):
        y = _LoraMatmul.apply(x2, w0, a, b, sc)
    else:
        y = ops.lora_matmul(x2, w0, a, b, sc)
    return y.reshape(*lead, w0.shape[-1])


def apply_lora(x: torch.Tensor, w0: torch.Tensor, adapter: Optional[Adapter],
               alpha: float) -> torch.Tensor:
    """y = x @ W0 + scale · (x @ A·m) @ (B·m), the adapter path in x.dtype
    as in the reference, through the fused ``ops.lora_matmul`` (a
    ``torch.autograd.Function`` when a gradient is wanted). The scale
    stays a device tensor. Stacked adapters (leading dims on A, B and mask,
    broadcast against x's and w0's) run one fused call per entry. W0, the
    factors and the mask may each require grad (pretraining trains them
    all; client training only A and B)."""
    if adapter is None:
        return x @ w0
    a, b = masked_factors(adapter)
    sc = lora_scale(adapter, alpha)
    if a.ndim == 2 and w0.ndim == 2:
        return _lora_2d(x, w0, a, b, sc)
    batch = torch.broadcast_shapes(x.shape[:-2], a.shape[:-2],
                                   w0.shape[:-2], sc.shape)

    def flat(t, tail):
        return t.expand(*batch, *t.shape[t.ndim - tail:]).reshape(
            -1, *t.shape[t.ndim - tail:])

    xs, ws, as_, bs = (flat(x, 2), flat(w0, 2), flat(a, 2), flat(b, 2))
    scs = sc.expand(batch).reshape(-1)
    ys = [_lora_2d(xs[i], ws[i], as_[i], bs[i], scs[i])
          for i in range(xs.shape[0])]
    return torch.stack(ys).reshape(*batch, x.shape[-2], w0.shape[-1])


def merge(w0: torch.Tensor, adapter: Adapter, alpha: float) -> torch.Tensor:
    """Fold the adapter into the base weights (deployment path)."""
    return w0 + delta_w(adapter, alpha).to(w0.dtype)
