"""Batched whole-tree aggregation engine, the server's hot path (port of
``repro/core/agg_engine.py``).

1. Group targets by leaf shapes (q and v at one width share a group).
2. Stack each group into one ``(T·L, K, d_in, r)`` batch (T targets × L
   layers).
3. Run the per-item math on the whole batch at once: masked, weighted
   factors → ``svd_factored_gram`` (or ``svd_factored``), or the dense
   Eq. 2 reconstruction through ``ops.recon_agg`` for ``method="exact"``
   and ``"randomized"`` → ``split_factors`` → per-client redistribution.
4. Unstack into the tree's layout.

Where the reference jit-compiles one vmapped pipeline per configuration,
the port runs eagerly: the batching is what it keeps, one ``recon_agg``
launch and one batched ``torch.linalg`` call per shape group, not one per
target or layer. ``ops.recon_agg`` chooses by the tensors' device, so on
a card the dense path always runs the CUDA kernel (the reference picks
its backend by a timed probe). The engine also returns the singular
spectrum it computed, per target and layer.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import svd as svd_lib
from repro_torch.kernels import ops

StackedAdapter = Dict[str, torch.Tensor]


def rank_for_energy(spectrum, energy: float, r_min: int, r_max: int) -> int:
    """Smallest rank whose leading singular directions capture ``energy``
    of the spectrum's total σ² energy, clamped to [r_min, r_max].

    ``spectrum``: (..., r) singular values, a tensor (read on the host) or
    an array; leading axes are pooled by mean energy (σ², then
    cumulate)."""
    if isinstance(spectrum, torch.Tensor):
        spectrum = spectrum.detach().cpu().numpy()
    s = np.asarray(spectrum, np.float64)
    s2 = np.mean(s.reshape(-1, s.shape[-1]) ** 2, axis=0)
    cum = np.cumsum(s2) / max(float(s2.sum()), 1e-30)
    r = int(np.searchsorted(cum, energy) + 1)
    return int(np.clip(r, r_min, r_max))


# ---------------------------------------------------------------------------
# The per-item math over a batch of items: a (N, K, d_in, r), b (N, K, r,
# d_out), mask (N, K, r), new_mask (N, K', r). Every quantity the reference
# computes per item (r_eff, the coefficients) stays per item.
# ---------------------------------------------------------------------------

def _coefficients(mask, eta, alpha) -> torch.Tensor:
    """η̂_k · s_k with s_k = alpha / r_eff_k (Eq. 2), (N, K)."""
    etan = eta / eta.sum()
    r_eff = torch.clamp(mask.sum(-1), min=1.0)
    return etan * alpha / r_eff


def _masked(a, b, mask):
    return a * mask[..., None, :], b * mask[..., :, None]


def _dense_update(a, b, mask, eta, alpha) -> torch.Tensor:
    """ΔW' = Σ_k coef_k (A_k·m_k)(B_k·m_k), (N, d_in, d_out): Eq. 2 in
    dense form, one ``recon_agg`` call for the batch. The kernel takes
    contiguous operands; a group of one target over a layer stack reaches
    here as a strided view of the stack."""
    coef = _coefficients(mask, eta, alpha)
    am, bm = _masked(a, b, mask)
    return ops.recon_agg(am.contiguous(), bm.contiguous(), coef.contiguous())


def _factored_update(a, b, mask, eta, alpha
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ΔW' = P Q unformed: P (N, d_in, K·r), Q (N, K·r, d_out)."""
    coef = _coefficients(mask, eta, alpha)
    am, bm = _masked(a, b, mask)
    am = am * coef[..., None, None]
    n, k, d_in, r = am.shape
    p = am.permute(0, 2, 1, 3).reshape(n, d_in, k * r)
    q = bm.reshape(n, k * r, bm.shape[-1])
    return p, q


def _redistribute(a_new, b_new, new_mask, alpha):
    """Per-client Eq. 3: mask to r_k, undo the client's forward scale."""
    inv_scale = torch.clamp(new_mask.sum(-1), min=1.0) / alpha
    a_out = a_new[:, None] * new_mask[..., None, :]
    b_out = b_new[:, None] * new_mask[..., :, None] * inv_scale[..., None,
                                                                None]
    return a_out, b_out


def _hlora_batch(a, b, mask, new_mask, *, eta, alpha, gen, method: str,
                 split: str, factored_impl: str):
    r_max = a.shape[-1]
    if method == "factored":
        p, q = _factored_update(a, b, mask, eta, alpha)
        svd_fn = svd_lib.svd_factored_gram if factored_impl == "gram" \
            else svd_lib.svd_factored
        u, s, vt = svd_fn(p, q, r_max)
    elif method == "exact":
        w = _dense_update(a, b, mask, eta, alpha)
        u, s, vt = svd_lib.svd_exact(w, r_max)
    elif method == "randomized":
        w = _dense_update(a, b, mask, eta, alpha)
        u, s, vt = svd_lib.svd_randomized(w, r_max, gen)
    else:
        raise ValueError(f"unknown svd method {method!r}")
    a_new, b_new = svd_lib.split_factors(u, s, vt, r_max, split)
    a_out, b_out = _redistribute(a_new, b_new, new_mask, alpha)
    return a_out, b_out, s


def _naive_batch(a, b, mask, new_mask, *, eta, **_unused):
    """Eq. 1 separate averaging: Ā, B̄ over the input client axis (the
    masks are the caller's). Naive runs no SVD: its spectrum is zeros."""
    etan = eta / eta.sum()
    am, bm = _masked(a, b, mask)
    a_bar = torch.einsum("k,nkir->nir", etan, am)
    b_bar = torch.einsum("k,nkro->nro", etan, bm)
    s = torch.zeros(a.shape[0], a.shape[-1], dtype=a.dtype, device=a.device)
    return a_bar[:, None].expand(a.shape), b_bar[:, None].expand(b.shape), s


class AggregationEngine:
    """Batched tree aggregation.

    Call returns ``(tree, spectra)``, where ``spectra[target]`` is the
    singular spectrum of that target's aggregated ΔW', shape ``(*stack,
    r_max)`` (zeros under the naive strategy, which runs no SVD).

    ``factored_impl`` picks ``method="factored"``'s SVD: ``"gram"``
    (shifted CholeskyQR2, all matrix products) or ``"qr"`` (Householder
    QR, the reference's per-target ``svd_factored``). The reference's
    ``mesh=`` (sharding the batch over devices) is not ported yet.
    """

    def __init__(self, factored_impl: str = "gram", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "AggregationEngine(mesh=...) is not ported yet")
        if factored_impl not in ("gram", "qr"):
            raise ValueError(f"unknown factored_impl {factored_impl!r}")
        self.factored_impl = factored_impl

    def __call__(self, adapters: Dict[str, StackedAdapter], eta, alpha: float,
                 *, strategy: str = "hlora",
                 new_masks: Optional[Dict[str, torch.Tensor]] = None,
                 method: str = "factored", split: str = "paper",
                 gen: Optional[torch.Generator] = None
                 ) -> Tuple[Dict[str, StackedAdapter],
                            Dict[str, torch.Tensor]]:
        """``eta`` (K,) FedAvg weights (a tensor, array or list; moved to
        the adapters' device and dtype). ``gen`` draws the randomized
        method's test matrices; None means a generator on the adapters'
        device seeded 0, as the reference's default key."""
        if strategy not in ("naive", "hlora"):
            raise ValueError(f"unknown strategy {strategy!r}")
        first = adapters[min(adapters)]["A"]
        eta = torch.as_tensor(eta, dtype=first.dtype, device=first.device)
        if gen is None:
            gen = torch.Generator(device=first.device).manual_seed(0)
        item = _naive_batch if strategy == "naive" else _hlora_batch
        run = partial(item, eta=eta, alpha=alpha, gen=gen, method=method,
                      split=split, factored_impl=self.factored_impl)
        groups: Dict[tuple, list] = {}
        for name in sorted(adapters):
            ad = adapters[name]
            nm = ad["mask"] if new_masks is None else new_masks[name]
            sig = (tuple(ad["A"].shape), tuple(ad["B"].shape),
                   tuple(ad["mask"].shape), tuple(nm.shape))
            groups.setdefault(sig, []).append(name)
        out: Dict[str, StackedAdapter] = {}
        spectra: Dict[str, torch.Tensor] = {}
        for _sig, members in sorted(groups.items()):
            new = None if new_masks is None else \
                {n: new_masks[n] for n in members}
            _run_group({n: adapters[n] for n in members}, new, run, out,
                       spectra)
        return out, spectra


def _run_group(group: Dict[str, StackedAdapter],
               new_masks: Optional[Dict[str, torch.Tensor]], run, out,
               spectra) -> None:
    """Stack one shape group into a (T·L, K, ...) batch, ``run`` the
    per-item math on it, and write each member's result into ``out`` and
    ``spectra``."""
    members = list(group)
    a = torch.stack([group[n]["A"] for n in members])
    b = torch.stack([group[n]["B"] for n in members])
    m = torch.stack([group[n]["mask"] for n in members])
    nm = m if new_masks is None else \
        torch.stack([new_masks[n] for n in members])
    t = a.shape[0]
    stack = tuple(a.shape[2:-2])
    batch = t * math.prod(stack)

    def to_batch(x, *mat):
        # (T, K, *stack, *mat) -> (T·L, K, *mat)
        perm = (0, *range(2, 2 + len(stack)), 1,
                *range(2 + len(stack), x.ndim))
        return x.permute(perm).reshape(batch, x.shape[1], *mat)

    def from_batch(x):
        # (T·L, K', *mat) -> (T, K', *stack, *mat)
        y = x.reshape(t, *stack, *x.shape[1:])
        perm = (0, 1 + len(stack), *range(1, 1 + len(stack)),
                *range(2 + len(stack), y.ndim))
        return y.permute(perm)

    a_o, b_o, s = run(to_batch(a, *a.shape[-2:]), to_batch(b, *b.shape[-2:]),
                      to_batch(m, m.shape[-1]), to_batch(nm, nm.shape[-1]))
    a_o, b_o = from_batch(a_o), from_batch(b_o)
    s = s.reshape(t, *stack, s.shape[-1])
    for i, name in enumerate(members):
        mask_out = group[name]["mask"] if new_masks is None \
            else new_masks[name]
        out[name] = {"A": a_o[i].contiguous(), "B": b_o[i].contiguous(),
                     "mask": mask_out}
        spectra[name] = s[i]


_default_engine: Optional[AggregationEngine] = None


def default_engine() -> AggregationEngine:
    """One shared engine (it holds no state beyond its settings)."""
    global _default_engine
    if _default_engine is None:
        _default_engine = AggregationEngine()
    return _default_engine
