"""Fused LoRA matmul for client training, forward and backward:

    forward   y  = x @ W0 + s * (x @ A) @ B          (and xa = x @ A)
    dx        dx = dy @ W0^T + s * g @ A^T,  g = dy @ B^T
    dA, dB    dA = s * x^T g,  dB = s * xa^T dy

x: (M, K), W0: (K, N), A: (K, R), B: (R, N), dy: (M, N); s a float32
scalar tensor. The forward takes float32 or bfloat16 (float64 on the
CPU); the backward refuses bfloat16, as bf16 training is not ported. The CUDA kernels are ``csrc/lora_matmul.cu`` (they replace
``repro/kernels/lora_matmul.py``, which had no backward); the ``*_plain``
functions are the same arithmetic in plain PyTorch. ``ops`` picks between
them by the tensors' device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

MAX_RANK = 64
MAX_ROWS = 65535 * 64        # the kernel's grid covers 64 rows per block


def _check_factors(op: str, rows: int, k: int, n: int, a, b) -> None:
    """a (K, R), b (R, N), 1 <= R <= MAX_RANK, rows <= MAX_ROWS."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[0] != k \
            or tuple(b.shape) != (a.shape[1], n):
        raise ValueError(f"{op}: factors a {tuple(a.shape)} b "
                         f"{tuple(b.shape)} do not fit W0 ({k}, {n})")
    if not 1 <= a.shape[1] <= MAX_RANK:
        raise ValueError(f"{op} supports ranks 1..{MAX_RANK}, got "
                         f"{a.shape[1]}")
    if rows > MAX_ROWS:
        raise ValueError(f"{op} supports at most {MAX_ROWS} rows, got "
                         f"{rows}")


def validate(x, w0, a, b) -> None:
    """x (M, K), w0 (K, N), a (K, R), b (R, N)."""
    if x.ndim != 2 or w0.ndim != 2 or x.shape[1] != w0.shape[0]:
        raise ValueError(f"lora_matmul expects x (M, K) and w0 (K, N); got "
                         f"{tuple(x.shape)} {tuple(w0.shape)}")
    _check_factors("lora_matmul", x.shape[0], *w0.shape, a, b)


def _check_grad_dtype(op: str, *ts) -> None:
    """The backward computes in float32 (float64 on the CPU, for
    gradcheck): bf16 training is not ported."""
    for t in ts:
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{op}: the backward takes float32, got "
                            f"{t.dtype} (bf16 training is not ported)")


def validate_dx(dy, w0, a, b) -> None:
    """dy (M, N) against the forward's w0 (K, N), a (K, R), b (R, N)."""
    _check_grad_dtype("lora_matmul_dx", dy, w0, a, b)
    if dy.ndim != 2 or w0.ndim != 2 or dy.shape[1] != w0.shape[1]:
        raise ValueError(f"lora_matmul_dx expects dy (M, N) for w0 (K, N); "
                         f"got {tuple(dy.shape)} {tuple(w0.shape)}")
    _check_factors("lora_matmul_dx", dy.shape[0], *w0.shape, a, b)


def validate_grad_ab(x, xa, dy, g) -> None:
    """x (M, K), xa (M, R), dy (M, N), g (M, R)."""
    _check_grad_dtype("lora_matmul_grad_ab", x, xa, dy, g)
    if any(t.ndim != 2 for t in (x, xa, dy, g)):
        raise ValueError("lora_matmul_grad_ab expects 2-D x, xa, dy, g")
    m, r = xa.shape
    if x.shape[0] != m or dy.shape[0] != m or tuple(g.shape) != (m, r):
        raise ValueError(
            f"lora_matmul_grad_ab shape mismatch: x {tuple(x.shape)} xa "
            f"{tuple(xa.shape)} dy {tuple(dy.shape)} g {tuple(g.shape)}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"lora_matmul_grad_ab supports ranks 1..{MAX_RANK}, "
                         f"got {r}")


def scale_tensor(scale, like: torch.Tensor) -> torch.Tensor:
    """The scale as a one-element float32 tensor on ``like``'s device (a
    Python number is copied there; a tensor must already be there)."""
    if not isinstance(scale, torch.Tensor):
        return torch.tensor(float(scale), dtype=torch.float32,
                            device=like.device)
    if scale.numel() != 1:
        raise ValueError(f"scale must hold one value, got shape "
                         f"{tuple(scale.shape)}")
    if scale.device != like.device:
        raise ValueError(f"scale lies on {scale.device}, the operands on "
                         f"{like.device}")
    return scale.reshape(()).to(torch.float32)


# ---------------------------------------------------------------------------
# plain versions (float32 arithmetic, or float64 for float64 operands;
# results in the operands' type)
# ---------------------------------------------------------------------------

def _acc(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.promote_types(t.dtype, torch.float32))


def lora_matmul_parts(x, w0, a, b, scale) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(y, xa): the forward and its bottleneck xa = x @ A (float32)."""
    xa = _acc(x) @ _acc(a)
    y = _acc(x) @ _acc(w0) + scale * (xa @ _acc(b))
    return y.to(x.dtype), xa


def lora_matmul_plain(x, w0, a, b, scale) -> torch.Tensor:
    """y = x @ W0 + scale * (x @ A) @ B (``repro.kernels.ref``'s oracle)."""
    return lora_matmul_parts(x, w0, a, b, scale)[0]


def lora_matmul_dx_plain(dy, w0, a, b, scale, need_dx: bool = True
                         ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(dx or None, g): g = dy @ B^T (float32), dx = dy @ W0^T + s g A^T."""
    g = _acc(dy) @ _acc(b).T
    if not need_dx:
        return None, g
    dx = _acc(dy) @ _acc(w0).T + scale * (g @ _acc(a).T)
    return dx.to(dy.dtype), g


def lora_matmul_grad_ab_plain(x, xa, dy, g, scale
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dA, dB) = (s x^T g, s xa^T dy), in x's and dy's type."""
    da = scale * (_acc(x).T @ g)
    db = scale * (xa.T @ _acc(dy))
    return da.to(x.dtype), db.to(dy.dtype)


# ---------------------------------------------------------------------------
# CUDA launches (on the current stream, no synchronisation)
# ---------------------------------------------------------------------------

def _check_f32(kernel: str, like: torch.Tensor, *ts) -> None:
    """The float32 operands (scale, xa, g): contiguous, on ``like``'s
    device."""
    for t in ts:
        if t.device != like.device:
            raise ValueError(f"{kernel}: every operand must be on one CUDA "
                             f"device, got {t.device} and {like.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{kernel}: xa, g and scale must be contiguous "
                            f"float32, got {t.dtype}")


def launch(lib, x, w0, a, b, scale, return_xa: bool = False):
    """The forward kernel: y, or (y, xa) with ``return_xa``."""
    code = _build.check_cuda_args("lora_matmul", (x, w0, a, b))
    _check_f32("lora_matmul", x, scale)
    m, k = x.shape
    n, r = w0.shape[1], a.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    xa = (torch.empty((m, r), dtype=torch.float32, device=x.device)
          if return_xa else None)
    with torch.cuda.device(x.device):
        rc = lib.lora_matmul_launch(
            x.data_ptr(), w0.data_ptr(), a.data_ptr(), b.data_ptr(),
            scale.data_ptr(), y.data_ptr(),
            xa.data_ptr() if xa is not None else None,
            m, n, k, r, 0, 1, code, _build.stream_of(x))
    _build.check(rc, "lora_matmul")
    return (y, xa) if return_xa else y


def launch_dx(lib, dy, w0, a, b, scale, need_dx: bool = True):
    """The dx kernel with W0, A and B read transposed: (dx or None, g).
    Without ``need_dx`` it computes g alone (no W0 product)."""
    code = _build.check_cuda_args("lora_matmul_dx", (dy, w0, a, b))
    _check_f32("lora_matmul_dx", dy, scale)
    m, n = dy.shape
    k, r = w0.shape[0], a.shape[1]
    g = torch.empty((m, r), dtype=torch.float32, device=dy.device)
    dx = (torch.empty((m, k), dtype=dy.dtype, device=dy.device)
          if need_dx else None)
    # in = dy (M, N): W' = W0^T, down = B^T (B stored (R, N)), up = A^T
    with torch.cuda.device(dy.device):
        rc = lib.lora_matmul_launch(
            dy.data_ptr(), w0.data_ptr(), b.data_ptr(), a.data_ptr(),
            scale.data_ptr(), dx.data_ptr() if need_dx else None,
            g.data_ptr(), m, k, n, r, 1, int(need_dx), code,
            _build.stream_of(dy))
    _build.check(rc, "lora_matmul_dx")
    return dx, g


def launch_grad_ab(lib, x, xa, dy, g, scale):
    """The dA/dB reduction kernel: (dA (K, R), dB (R, N))."""
    code = _build.check_cuda_args("lora_matmul_grad_ab", (x, dy))
    _check_f32("lora_matmul_grad_ab", x, xa, g, scale)
    m, k = x.shape
    n, r = dy.shape[1], xa.shape[1]
    da = torch.empty((k, r), dtype=x.dtype, device=x.device)
    db = torch.empty((r, n), dtype=dy.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.lora_grad_ab_launch(
            x.data_ptr(), g.data_ptr(), xa.data_ptr(), dy.data_ptr(),
            scale.data_ptr(), da.data_ptr(), db.data_ptr(), m, k, n, r, code,
            _build.stream_of(x))
    _build.check(rc, "lora_matmul_grad_ab")
    return da, db
