"""The port's kernel entry points: what the rest of ``repro_torch`` calls.

Each op checks shapes, then chooses by the device of its tensors: CPU
tensors go to the plain PyTorch version, CUDA tensors to the hand-written
kernel (built on first use by ``_build``). There is no fallback between
the two: a CUDA call either launches its kernel or raises.

``LAUNCHES`` counts kernel launches per op. An op adds one exactly where
it launches its kernel, so a run that reads the counts can show which
kernels its path went through.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import bgmv as _bgmv
from repro_torch.kernels import flash_attn as _flash
from repro_torch.kernels import lora_matmul as _lora
from repro_torch.kernels import paged_attn as _paged
from repro_torch.kernels import verify as _verify

LAUNCHES: Dict[str, int] = {"bgmv": 0, "paged_attention": 0,
                            "flash_attention": 0,
                            "paged_verify_attention": 0,
                            "lora_matmul": 0, "lora_matmul_dx": 0,
                            "lora_matmul_grad_ab": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{op}: unsupported device {t.device}")


def bgmv(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         idx: torch.Tensor) -> torch.Tensor:
    """Multi-LoRA decode gather: y[i] = x[i] @ A[idx[i]] @ B[idx[i]].
    x: (B, d_in), a: (S, d_in, R), b: (S, R, d_out), idx: (B,) int32. Rank
    masks and the alpha/r_eff scale are the caller's business."""
    _bgmv.validate(x, a, b, idx)
    if _on_cpu(x, "bgmv"):
        return _bgmv.bgmv_plain(x, a, b, idx)
    lib = _build.load()
    LAUNCHES["bgmv"] += 1
    return _bgmv.launch(lib, x, a, b, idx)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_tables: torch.Tensor,
                    lengths: torch.Tensor, *, page_size: int
                    ) -> torch.Tensor:
    """One decode token per row against the page pool: q (B, H, Dh),
    pools (NP, page_size, Hkv, Dh), page_tables (B, P), lengths (B,)."""
    _paged.validate(q, k_pool, v_pool, page_tables, lengths)
    if _on_cpu(q, "paged_attention"):
        return _paged.paged_attention_plain(q, k_pool, v_pool, page_tables,
                                            lengths)
    lib = _build.load()
    LAUNCHES["paged_attention"] += 1
    return _paged.launch(lib, q, k_pool, v_pool, page_tables, lengths,
                         page_size)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset=None) -> torch.Tensor:
    """Batched attention with a causal mask at absolute offset
    ``q_offset`` (None, an int, or a (B,) int tensor) and an optional
    sliding window. q (B, Sq, H, D), k/v (B, Skv, Hkv, D)."""
    _flash.validate(q, k, v, window)
    if _on_cpu(q, "flash_attention"):
        return _flash.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, q_offset=q_offset)
    lib = _build.load()
    LAUNCHES["flash_attention"] += 1
    return _flash.launch(lib, q, k, v, causal=causal, window=window,
                         q_offset=q_offset)


def paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_tables: torch.Tensor,
                           lengths: torch.Tensor, q_offsets: torch.Tensor, *,
                           page_size: int) -> torch.Tensor:
    """Speculative verify: q (B, Sq, H, Dh), token i of row b at absolute
    position q_offsets[b] + i, against the page pool (NP, page_size, Hkv,
    Dh) through page_tables (B, P); causal within each row's window and
    masked at lengths[b] (B,)."""
    _verify.validate(q, k_pool, v_pool, page_tables, lengths, q_offsets)
    if _on_cpu(q, "paged_verify_attention"):
        return _verify.paged_verify_attention_plain(
            q, k_pool, v_pool, page_tables, lengths, q_offsets)
    lib = _build.load()
    LAUNCHES["paged_verify_attention"] += 1
    return _verify.launch(lib, q, k_pool, v_pool, page_tables, lengths,
                          q_offsets, page_size)


def lora_matmul(x: torch.Tensor, w0: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale, *, return_xa: bool = False):
    """Fused y = x @ W0 + scale * (x @ A) @ B with x (M, K), w0 (K, N),
    a (K, R), b (R, N); ``scale`` a Python number or a one-element tensor
    on x's device (read by the kernel, never copied to the host). With
    ``return_xa`` also the float32 bottleneck xa = x @ A (M, R), which the
    backward needs."""
    _lora.validate(x, w0, a, b)
    scale = _lora.scale_tensor(scale, x)
    if _on_cpu(x, "lora_matmul"):
        y, xa = _lora.lora_matmul_parts(x, w0, a, b, scale)
        return (y, xa) if return_xa else y
    lib = _build.load()
    LAUNCHES["lora_matmul"] += 1
    return _lora.launch(lib, x, w0, a, b, scale, return_xa)


def lora_matmul_dx(dy: torch.Tensor, w0: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, scale, *, need_dx: bool = True
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Backward to the input: (dx, g) with g = dy @ B^T (M, R) float32 and
    dx = dy @ W0^T + scale * g @ A^T (M, K); dy (M, N) and the forward's
    w0, a, b. Without ``need_dx``, (None, g): g alone, no W0 product."""
    _lora.validate_dx(dy, w0, a, b)
    scale = _lora.scale_tensor(scale, dy)
    if _on_cpu(dy, "lora_matmul_dx"):
        return _lora.lora_matmul_dx_plain(dy, w0, a, b, scale, need_dx)
    lib = _build.load()
    LAUNCHES["lora_matmul_dx"] += 1
    return _lora.launch_dx(lib, dy, w0, a, b, scale, need_dx)


def lora_matmul_grad_ab(x: torch.Tensor, xa: torch.Tensor, dy: torch.Tensor,
                        g: torch.Tensor, scale
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward to the factors: dA = scale * x^T g (K, R) and dB = scale *
    xa^T dy (R, N), from the forward's x (M, K) and xa, dy (M, N) and the
    dx op's g."""
    _lora.validate_grad_ab(x, xa, dy, g)
    scale = _lora.scale_tensor(scale, x)
    if _on_cpu(x, "lora_matmul_grad_ab"):
        return _lora.lora_matmul_grad_ab_plain(x, xa, dy, g, scale)
    lib = _build.load()
    LAUNCHES["lora_matmul_grad_ab"] += 1
    return _lora.launch_grad_ab(lib, x, xa, dy, g, scale)
