"""Server-side aggregation strategies, the heart of the paper (port of
``repro/core/aggregate.py``).

Inputs are client-stacked adapters: every leaf has a leading K axis
(clients), possibly followed by stack axes (layers), then the matrix axes.
``eta: (K,)`` are the FedAvg weights n_k, normalised here.

``aggregate_naive``   Eq. 1: average A and B separately, Ā = Σ η_k A_k,
                      B̄ = Σ η_k B_k; with rank masks, the zero-padding
                      scheme of Cho et al. 2023. Biased.
``aggregate_hlora``   Eq. 2 + 3: reconstruct each client's update
                      s_k (A_k·m_k)(B_k·m_k), FedAvg exactly, re-decompose
                      with an SVD and hand each client the rank-r_k
                      truncation (Eckart–Young).

Stack axes batch through ``torch.linalg`` (the reference vmaps).
``aggregate_tree`` runs the batched ``AggregationEngine``;
``aggregate_tree_reference`` keeps the per-target loop as its oracle.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import agg_engine
from repro_torch.core import svd as svd_lib
from repro_torch.core.lora import lora_scale, masked_factors

StackedAdapter = Dict[str, torch.Tensor]   # leaves have leading (K, ...) axes


def _norm_weights(eta: torch.Tensor) -> torch.Tensor:
    return eta / eta.sum()


def _bcast(eta: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(K,) weights shaped to broadcast over (K, ...) ``like``."""
    return eta.reshape((-1,) + (1,) * (like.ndim - 1))


def aggregate_naive(stacked: StackedAdapter, eta: torch.Tensor,
                    new_masks: Optional[torch.Tensor] = None
                    ) -> StackedAdapter:
    """Separate averaging of A and B. Every client gets the same Ā, B̄
    (masked directions enter the average as zeros: Cho et al.'s padding
    bias), with its mask or ``new_masks``."""
    eta = _norm_weights(eta)
    a_m, b_m = masked_factors(stacked)
    a_bar = (_bcast(eta, a_m) * a_m).sum(0)
    b_bar = (_bcast(eta, b_m) * b_m).sum(0)
    masks = stacked["mask"] if new_masks is None else new_masks
    return {"A": a_bar.expand(stacked["A"].shape).contiguous(),
            "B": b_bar.expand(stacked["B"].shape).contiguous(),
            "mask": masks}


def _coefficients(stacked: StackedAdapter, eta: torch.Tensor,
                  alpha: float) -> torch.Tensor:
    """η̂_k · s_k, shaped (K, *stack)."""
    scale = lora_scale(stacked, alpha)
    return _bcast(_norm_weights(eta), scale) * scale


def reconstruct_global_update(stacked: StackedAdapter, eta: torch.Tensor,
                              alpha: float) -> torch.Tensor:
    """ΔW' = Σ_k η_k · s_k · (A_k·m_k)(B_k·m_k)   (dense form, Eq. 2)."""
    a, b = masked_factors(stacked)
    coef = _coefficients(stacked, eta, alpha)
    return torch.einsum("k...,k...ir,k...ro->...io", coef, a, b)


def reconstruct_factored(stacked: StackedAdapter, eta: torch.Tensor,
                         alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """ΔW' as (P, Q), P (..., d_in, K·r_max), Q (..., K·r_max, d_out), the
    coefficient η_k·s_k folded into P; the dense update is never formed."""
    a, b = masked_factors(stacked)
    a = a * _coefficients(stacked, eta, alpha)[..., None, None]
    return torch.cat(a.unbind(0), dim=-1), torch.cat(b.unbind(0), dim=-2)


def aggregate_hlora(stacked: StackedAdapter, eta: torch.Tensor, alpha: float,
                    new_masks: Optional[torch.Tensor] = None,
                    method: str = "factored", split: str = "paper",
                    gen: Optional[torch.Generator] = None) -> StackedAdapter:
    """Reconstruct → FedAvg → SVD → per-client rank-r_k redistribution:
    s'_k · (A'_k B'_k) = [ΔW']_{r_k} (Eq. 3). The client's forward scale
    s'_k = alpha / r'_k is divided back out of B' so the effective update
    is preserved exactly. ``gen`` draws ``method="randomized"``'s test
    matrix."""
    r_max = stacked["A"].shape[-1]
    masks = stacked["mask"] if new_masks is None else new_masks
    if method == "factored":
        p, q = reconstruct_factored(stacked, eta, alpha)
        u, s, vt = svd_lib.svd_factored(p, q, r_max)
    elif method == "exact":
        w = reconstruct_global_update(stacked, eta, alpha)
        u, s, vt = svd_lib.svd_exact(w, r_max)
    elif method == "randomized":
        w = reconstruct_global_update(stacked, eta, alpha)
        u, s, vt = svd_lib.svd_randomized(w, r_max, gen)
    else:
        raise ValueError(f"unknown svd method {method!r}")
    a_new, b_new = svd_lib.split_factors(u, s, vt, r_max, split)
    inv_scale = torch.clamp(masks.sum(-1), min=1.0) / alpha   # (K, *stack)
    a_out = a_new[None] * masks[..., None, :]
    b_out = (b_new[None] * masks[..., :, None]) * inv_scale[..., None, None]
    return {"A": a_out, "B": b_out, "mask": masks}


def aggregate_tree(adapters: Dict[str, StackedAdapter], eta: torch.Tensor,
                   alpha: float, strategy: str = "hlora",
                   new_masks: Optional[Dict[str, torch.Tensor]] = None,
                   method: str = "factored", split: str = "paper",
                   gen: Optional[torch.Generator] = None,
                   engine: Optional[agg_engine.AggregationEngine] = None
                   ) -> Dict[str, StackedAdapter]:
    """The chosen aggregation for every LoRA target in the tree, through
    the batched :class:`~repro_torch.core.agg_engine.AggregationEngine`
    (``engine``, or the shared default)."""
    eng = engine if engine is not None else agg_engine.default_engine()
    out, _spectra = eng(adapters, eta, alpha, strategy=strategy,
                        new_masks=new_masks, method=method, split=split,
                        gen=gen)
    return out


def aggregate_tree_reference(
        adapters: Dict[str, StackedAdapter], eta: torch.Tensor, alpha: float,
        strategy: str = "hlora",
        new_masks: Optional[Dict[str, torch.Tensor]] = None,
        method: str = "factored", split: str = "paper",
        gen: Optional[torch.Generator] = None) -> Dict[str, StackedAdapter]:
    """The per-target loop, unbatched: the oracle the engine is held to."""
    out = {}
    for name in sorted(adapters):
        nm = None if new_masks is None else new_masks[name]
        if strategy == "naive":
            out[name] = aggregate_naive(adapters[name], eta, nm)
        elif strategy == "hlora":
            out[name] = aggregate_hlora(adapters[name], eta, alpha, nm,
                                        method=method, split=split, gen=gen)
        else:
            raise ValueError(f"unknown strategy {strategy!r}")
    return out


def aggregation_bias(stacked: StackedAdapter, eta: torch.Tensor,
                     alpha: float) -> torch.Tensor:
    """‖(Σ η A)(Σ η B) − Σ η (A B)‖_F / ‖Σ η (A B)‖_F over all stack axes:
    Eq. 1's bias, measured. Zero iff K = 1 or all clients agree."""
    exact = reconstruct_global_update(stacked, eta, alpha)
    naive = aggregate_naive(stacked, eta)
    first = {k: v[0] for k, v in naive.items()}
    a0, b0 = masked_factors(first)
    approx = lora_scale(first, alpha)[..., None, None] * (a0 @ b0)
    return torch.linalg.vector_norm(exact - approx) / torch.clamp(
        torch.linalg.vector_norm(exact), min=1e-30)
