"""Batched-gather matrix-vector (BGMV) product for multi-LoRA decode:

    y[i] = x[i] @ A[idx[i]] @ B[idx[i]]        i = 0..B-1

x: (B, d_in), A: (S, d_in, R), B: (S, R, d_out), idx: (B,) int32. The CUDA
kernel is ``csrc/bgmv.cu`` (it replaces ``repro/kernels/bgmv.py``);
``bgmv_plain`` is the same function in plain PyTorch. ``ops.bgmv`` picks
between them by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_RANK = 64


def validate(x, a, b, idx) -> None:
    if x.ndim != 2 or a.ndim != 3 or b.ndim != 3 or idx.ndim != 1:
        raise ValueError(
            f"bgmv expects x (B, d_in), a (S, d_in, R), b (S, R, d_out), "
            f"idx (B,); got {tuple(x.shape)} {tuple(a.shape)} "
            f"{tuple(b.shape)} {tuple(idx.shape)}")
    bsz, d_in = x.shape
    s, ad, r = a.shape
    if ad != d_in or b.shape[0] != s or b.shape[1] != r or idx.shape[0] != bsz:
        raise ValueError(
            f"bgmv shape mismatch: x {tuple(x.shape)} a {tuple(a.shape)} "
            f"b {tuple(b.shape)} idx {tuple(idx.shape)}")


def bgmv_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """Gather-einsum reference, float32 accumulation, output in x.dtype."""
    i = idx.long()
    xa = torch.einsum("bd,bdr->br", x.float(), a[i].float())
    return torch.einsum("br,bro->bo", xa, b[i].float()).to(x.dtype)


def launch(lib, x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           idx: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel on the current stream (no synchronisation)."""
    code = _build.check_cuda_args("bgmv", (x, a, b), (idx,))
    r = a.shape[2]
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"bgmv kernel supports ranks 1..{MAX_RANK}, got {r}")
    y = torch.empty((x.shape[0], b.shape[2]), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.bgmv_launch(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                             idx.data_ptr(), y.data_ptr(), x.shape[0],
                             x.shape[1], r, b.shape[2], a.shape[0], code,
                             _build.stream_of(x))
    _build.check(rc, "bgmv")
    return y
