"""Flash attention with a causal mask at a run-time absolute offset and an
optional sliding window (the chunked-prefill contract).

q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) with Hkv dividing H; query i of
row b sits at absolute position ``q_offset[b] + i`` (``q_offset`` None:
q is the suffix of kv, Skv - Sq; an int: one offset for every row; a
(B,) int tensor: one per row) and key j at position j. A query whose keys
are all masked gives zeros. The CUDA kernel is ``csrc/flash_attn.cu`` (it
replaces ``repro/kernels/flash_attn.py``); ``flash_attention_plain`` is
the same function in plain PyTorch.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attn import NEG_INF


def validate(q, k, v, window) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention expects q (B, Sq, H, D), k/v (B, Skv, Hkv, "
            f"D); got {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(
            f"flash_attention shape mismatch: q {tuple(q.shape)} k "
            f"{tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _offsets(q_offset, b: int, sq: int, skv: int, device) -> torch.Tensor:
    if q_offset is None:
        return torch.full((b,), skv - sq, dtype=torch.long, device=device)
    if isinstance(q_offset, torch.Tensor):
        return q_offset.to(device=device, dtype=torch.long).reshape(
            -1).expand(b)
    return torch.full((b,), int(q_offset), dtype=torch.long, device=device)


def visibility(q_offset, sq: int, skv: int, b: int, causal: bool,
               window: Optional[int], device) -> torch.Tensor:
    """(B, Sq, Skv) bool: which keys each query sees."""
    qpos = _offsets(q_offset, b, sq, skv, device)[:, None] \
        + torch.arange(sq, device=device)[None, :]
    kpos = torch.arange(skv, device=device)[None, None, :]
    mask = torch.ones((b, sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos[:, :, None]
    if window is not None:
        mask &= kpos > qpos[:, :, None] - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          q_offset=None) -> torch.Tensor:
    """Masked softmax attention in float32, all-masked queries -> 0."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    mask = visibility(q_offset, sq, skv, b, causal, window, q.device)
    kk = k.float().repeat_interleave(h // hkv, dim=2)
    vv = v.float().repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / math.sqrt(d)
    logits = torch.where(mask[:, None], logits,
                         torch.full_like(logits, NEG_INF))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), vv)
    out = out * mask.any(-1)[:, :, None, None]
    return out.to(q.dtype)


def launch(lib, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: Optional[int], q_offset) -> torch.Tensor:
    """Run the CUDA kernel on the current stream (no synchronisation).
    An int (or None) offset is passed by value; a tensor offset must be a
    (B,) int32 CUDA tensor."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if isinstance(q_offset, torch.Tensor):
        if q_offset.shape != (b,):
            raise ValueError(f"q_offset tensor must have shape ({b},), got "
                             f"{tuple(q_offset.shape)}")
        offsets, scalar = q_offset, 0
        code = _build.check_cuda_args("flash_attention", (q, k, v),
                                      (q_offset,))
    else:
        offsets, scalar = None, skv - sq if q_offset is None else int(q_offset)
        code = _build.check_cuda_args("flash_attention", (q, k, v))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if offsets is None else offsets.data_ptr(), scalar,
            out.data_ptr(), b, sq, skv, h, hkv, d, int(bool(causal)),
            -1 if window is None else int(window), 1.0 / math.sqrt(d), code,
            _build.stream_of(q))
    _build.check(rc, "flash_attention")
    return out
