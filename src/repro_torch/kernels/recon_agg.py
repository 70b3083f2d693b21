"""Reconstruct-aggregate for HLoRA's server (Eq. 2):

    W' = Σ_k η_k · A_k B_k        A: (Kc, d_in, R), B: (Kc, R, d_out)

in the reference's single-item form (eta (Kc,), W' (d_in, d_out)) or
batched over items (a (Bt, Kc, d_in, R), b (Bt, Kc, R, d_out), eta
(Bt, Kc), W' (Bt, d_in, d_out)); W' is float32. The CUDA kernel is
``csrc/recon_agg.cu`` (it replaces ``repro/kernels/recon_agg.py``) and
takes float32 only; ``recon_agg_plain`` is the same function in plain
PyTorch. ``ops.recon_agg`` picks between them by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_RANK = 64
MAX_ITEMS = 2**31 - 1        # int arguments; persistent blocks walk the
MAX_ROWS = 2**31 - 1         # tiles with a 64-bit index
MAX_DEPTH = 2**22 - 1        # Kc*R: the kernel divides by R in float32


def validate(a, b, eta) -> bool:
    """Check the shapes of either form; True for the single-item form."""
    if a.ndim == 3 and b.ndim == 3 and eta.ndim == 1:
        single = True
    elif a.ndim == 4 and b.ndim == 4 and eta.ndim == 2:
        single = False
    else:
        raise ValueError(
            f"recon_agg expects a (Kc, d_in, R), b (Kc, R, d_out), eta (Kc,) "
            f"or a batch of them, got {tuple(a.shape)} {tuple(b.shape)} "
            f"{tuple(eta.shape)}")
    lead = a.shape[:-2]
    if b.shape[:-2] != lead or eta.shape != lead \
            or b.shape[-2] != a.shape[-1]:
        raise ValueError(f"recon_agg shape mismatch: a {tuple(a.shape)} b "
                         f"{tuple(b.shape)} eta {tuple(eta.shape)}")
    return single


def recon_agg_plain(a: torch.Tensor, b: torch.Tensor, eta: torch.Tensor
                    ) -> torch.Tensor:
    """The batched form as one einsum, float32 arithmetic (float64 for
    float64 operands)."""
    acc = torch.promote_types(a.dtype, torch.float32)
    return torch.einsum("bk,bkir,bkro->bio", eta.to(acc), a.to(acc),
                        b.to(acc))


def launch(lib, a: torch.Tensor, b: torch.Tensor, eta: torch.Tensor
           ) -> torch.Tensor:
    """Run the CUDA kernel on the batched form, on the current stream (no
    synchronisation). Refuses what the kernel does not take: other than
    float32, rank 0 or above MAX_RANK, CPU tensors."""
    validate(a, b, eta)
    if a.ndim != 4:
        raise ValueError("recon_agg launch takes the batched form")
    if any(t.dtype != torch.float32 for t in (a, b, eta)):
        raise TypeError(f"recon_agg kernel takes float32, got "
                        f"{[t.dtype for t in (a, b, eta)]}")
    bt, kc, d_in, r = a.shape
    d_out = b.shape[-1]
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"recon_agg kernel supports ranks 1..{MAX_RANK}, "
                         f"got {r}")
    if kc * r > MAX_DEPTH:
        raise ValueError(f"recon_agg kernel supports Kc*R <= {MAX_DEPTH}, "
                         f"got {kc}*{r}")
    if bt > MAX_ITEMS or d_in > MAX_ROWS:
        raise ValueError(f"recon_agg kernel supports at most {MAX_ITEMS} "
                         f"items of {MAX_ROWS} rows, got {bt} of {d_in}")
    _build.check_cuda_args("recon_agg", (a, b, eta))
    out = torch.empty((bt, d_in, d_out), dtype=torch.float32,
                      device=a.device)
    with torch.cuda.device(a.device):
        rc = lib.recon_agg_launch(a.data_ptr(), b.data_ptr(), eta.data_ptr(),
                                  out.data_ptr(), bt, kc, d_in, r, d_out,
                                  _build.stream_of(a))
    _build.check(rc, "recon_agg")
    return out
