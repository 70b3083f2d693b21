"""SVD back-ends for HLoRA's server-side re-decomposition (Eq. 3) (port
of ``repro/core/svd.py``).

- ``svd_exact``         ``torch.linalg.svd`` of the dense ΔW (``gesvd`` on
                        CUDA). The oracle.
- ``svd_factored``      exact top-r SVD of ``p @ q`` without forming it:
                        QR of the tall-skinny factors, SVD of the R×R core.
- ``svd_factored_gram`` the same with shifted CholeskyQR2 in place of the
                        Householder QR: all matrix products, the engine's
                        default.
- ``svd_randomized``    range finder with subspace iteration for a dense W
                        (Halko et al. 2011).

All return ``(U, s, Vt)`` of shapes (..., d_in, r), (..., r), (..., r,
d_out) and take any leading batch axes, since ``torch.linalg`` batches:
the reference's vmap over (targets × layers) is the batch axis here, and
every quantity the reference computes per matrix (the Cholesky shift's
‖G‖∞) stays per matrix.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def svd_exact(w: torch.Tensor, r: int) -> Triple:
    """On CUDA through cuSOLVER's QR-based ``gesvd``. PyTorch's default
    there, the Jacobi ``gesvdj``, loses precision on ill-conditioned input,
    and ΔW (rank ≤ Σ r_k of d) always is ill-conditioned. On 48 trained
    RoBERTa-large items (H100), ``gesvdj`` was 9.7e-5·σ₁ from a float64
    SVD and ``gesvd`` 4.6e-7·σ₁, in less time."""
    driver = "gesvd" if w.is_cuda else None
    u, s, vt = torch.linalg.svd(w, full_matrices=False, driver=driver)
    return u[..., :, :r], s[..., :r], vt[..., :r, :]


def svd_factored(p: torch.Tensor, q: torch.Tensor, r: int) -> Triple:
    """Exact top-r SVD of ``p @ q`` without forming it; p (..., d_in, R),
    q (..., R, d_out). QR(p) = Qp Rp, QR(qᵀ) = Qq Rq, SVD(Rp Rqᵀ) =
    Û s V̂ᵀ; U = Qp Û, Vᵀ = (Qq V̂)ᵀ."""
    qp, rp = torch.linalg.qr(p, mode="reduced")
    qq, rq = torch.linalg.qr(q.mT, mode="reduced")
    uu, s, vvt = torch.linalg.svd(rp @ rq.mT, full_matrices=False)
    u = qp @ uu
    vt = (qq @ vvt.mT).mT
    return u[..., :, :r], s[..., :r], vt[..., :r, :]


def _cholqr2(x: torch.Tensor, shift: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shifted CholeskyQR2 of a tall-skinny ``x`` (..., d, R): X = Q R.

    Returns ``(R⁻¹, R)``: Q = X R⁻¹ is only ever needed applied to r ≪ R
    columns, so the caller composes the small matrices first. Pass 1
    factors G + λI with λ = ``shift``·‖G‖∞ of each matrix's own Gram G
    (‖G‖∞ ≥ λmax keeps the pivots ≥ λ when X is numerically rank-deficient,
    as federated factors are); pass 2 re-factors the Gram of Q₁, computed
    in data space, with a fixed 3e-5 guard (see the reference for the
    reasoning behind both shifts). ``cholesky_ex`` neither raises nor syncs
    the host; a pivot that is not positive gives NaN, as the reference's
    Cholesky does.
    """
    rr = x.shape[-1]
    eye = torch.eye(rr, dtype=x.dtype, device=x.device)

    def shifted_chol(g, rel):
        norm_inf = g.abs().sum(-1).amax(-1, keepdim=True)[..., None]
        lam = rel * torch.clamp(norm_inf, min=1e-30)
        l, info = torch.linalg.cholesky_ex(g + lam * eye)
        l = torch.where((info > 0)[..., None, None], torch.nan, l)
        return torch.linalg.solve_triangular(
            l.mT, eye.expand_as(l), upper=True), l

    inv1, l1 = shifted_chol(x.mT @ x, shift)
    q1 = x @ inv1
    inv2, l2 = shifted_chol(q1.mT @ q1, 3e-5)
    return inv1 @ inv2, l2.mT @ l1.mT


def svd_factored_gram(p: torch.Tensor, q: torch.Tensor, r: int,
                      shift: float = 1e-4) -> Triple:
    """Top-r SVD of ``p @ q`` through shifted CholeskyQR2 (``_cholqr2``)
    of both factors, then as ``svd_factored``: core = Rp Rqᵀ, SVD(core) =
    Û s V̂ᵀ, U = Qp Û_r, Vᵀ = (Qq V̂_r)ᵀ as two thin products."""
    rinv_p, rp = _cholqr2(p, shift)
    rinv_q, rq = _cholqr2(q.mT, shift)
    uu, s, vvt = torch.linalg.svd(rp @ rq.mT, full_matrices=False)
    u = p @ (rinv_p @ uu[..., :, :r])
    vt = (q.mT @ (rinv_q @ vvt.mT[..., :, :r])).mT
    return u, s[..., :r], vt


def svd_randomized(w: torch.Tensor, r: int,
                   gen: Optional[torch.Generator] = None,
                   oversample: int = 8, iters: int = 2) -> Triple:
    """Randomized range finder and subspace iteration (Halko et al. 2011).

    Exact to float precision when rank(w) ≤ r + oversample; otherwise the
    error is bounded by the (r+1)-th singular value. The test matrix is
    drawn from ``gen`` (on w's device; the default generator if None); its
    draws are not ``jax.random``'s.
    """
    d_in, d_out = w.shape[-2:]
    l = min(r + oversample, min(d_in, d_out))
    omega = torch.randn((*w.shape[:-2], d_out, l), generator=gen,
                        dtype=w.dtype, device=w.device)
    y = w @ omega
    for _ in range(iters):
        q, _ = torch.linalg.qr(y, mode="reduced")
        qz, _ = torch.linalg.qr(w.mT @ q, mode="reduced")
        y = w @ qz
    q, _ = torch.linalg.qr(y, mode="reduced")
    ub, s, vt = torch.linalg.svd(q.mT @ w, full_matrices=False)
    u = q @ ub
    return u[..., :, :r], s[..., :r], vt[..., :r, :]


def split_factors(u: torch.Tensor, s: torch.Tensor, vt: torch.Tensor, r: int,
                  split: str = "paper") -> Tuple[torch.Tensor, torch.Tensor]:
    """Truncate to rank r and split into (A', B') per Eq. 3.

    'paper':  A' = U_r            B' = Σ_r V_rᵀ
    'sqrt':   A' = U_r √Σ_r       B' = √Σ_r V_rᵀ   (balanced)
    """
    u_r, s_r, vt_r = u[..., :, :r], s[..., :r], vt[..., :r, :]
    if split == "paper":
        return u_r, s_r[..., :, None] * vt_r
    if split == "sqrt":
        sq = torch.sqrt(torch.clamp(s_r, min=0.0))
        return u_r * sq[..., None, :], sq[..., :, None] * vt_r
    raise ValueError(f"unknown split {split!r}")


def truncation_error(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                     ) -> torch.Tensor:
    """Relative Frobenius error ‖W − AB‖_F / ‖W‖_F, per matrix."""
    return torch.linalg.matrix_norm(w - a @ b) / torch.clamp(
        torch.linalg.matrix_norm(w), min=1e-30)
