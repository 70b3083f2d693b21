"""Paged-attention decode: one query token per row against a paged KV pool.

q: (B, H, Dh); k_pool/v_pool: (NP, page_size, Hkv, Dh) with Hkv dividing
H; page_tables: (B, P) int32 naming the pages that hold row b's positions
[j*page_size, (j+1)*page_size); lengths: (B,) int32. Positions at or past
lengths[b] are masked; rows of length 0 give exact zeros. The softmax
scale is 1/sqrt(Dh). The CUDA kernel is ``csrc/paged_attn.cu`` (it
replaces ``repro/kernels/paged_attn.py``); ``paged_attention_plain`` is the
same function in plain PyTorch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

# Masked score sentinel, as ``kNegInf`` in csrc/common.cuh and the
# reference's attention; the attention plain versions and
# ``models/common.py`` use this one.
NEG_INF = -1e30


def validate(q, k_pool, v_pool, page_tables, lengths) -> None:
    if q.ndim != 3 or k_pool.ndim != 4 or page_tables.ndim != 2 \
            or lengths.ndim != 1:
        raise ValueError(
            f"paged_attention expects q (B, H, Dh), pools (NP, ps, Hkv, "
            f"Dh), tables (B, P), lengths (B,); got {tuple(q.shape)} "
            f"{tuple(k_pool.shape)} {tuple(page_tables.shape)} "
            f"{tuple(lengths.shape)}")
    b, h, dh = q.shape
    _, _, hkv, pdh = k_pool.shape
    if v_pool.shape != k_pool.shape or pdh != dh or h % hkv \
            or page_tables.shape[0] != b or lengths.shape[0] != b:
        raise ValueError(
            f"paged_attention shape mismatch: q {tuple(q.shape)} k_pool "
            f"{tuple(k_pool.shape)} v_pool {tuple(v_pool.shape)} tables "
            f"{tuple(page_tables.shape)} lengths {tuple(lengths.shape)}")


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, page_tables: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Gather the row's pages, mask at the length, softmax in float32."""
    b, h, dh = q.shape
    _, ps, hkv, _ = k_pool.shape
    p = page_tables.shape[1]
    t = page_tables.long()
    groups = h // hkv
    kk = k_pool[t].reshape(b, p * ps, hkv, dh).float()
    vv = v_pool[t].reshape(b, p * ps, hkv, dh).float()
    kk = kk.repeat_interleave(groups, dim=2)        # head h*G+g <- kv head h
    vv = vv.repeat_interleave(groups, dim=2)
    logits = torch.einsum("bhd,bshd->bhs", q.float(), kk) / math.sqrt(dh)
    valid = torch.arange(p * ps, device=q.device)[None, :] \
        < lengths.to(q.device).long()[:, None]
    logits = torch.where(valid[:, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    out = torch.einsum("bhs,bshd->bhd", torch.softmax(logits, -1), vv)
    # empty rows give exact zeros, not a fully-masked softmax's uniform mix
    out = out * (lengths.to(q.device) > 0)[:, None, None]
    return out.to(q.dtype)


def launch(lib, q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
           page_tables: torch.Tensor, lengths: torch.Tensor,
           page_size: int) -> torch.Tensor:
    """Run the CUDA kernel on the current stream (no synchronisation)."""
    code = _build.check_cuda_args("paged_attention", (q, k_pool, v_pool),
                                  (page_tables, lengths))
    b, h, dh = q.shape
    hkv = k_pool.shape[2]
    if page_size != k_pool.shape[1]:
        raise ValueError(f"page_size {page_size} != pool slot axis "
                         f"{k_pool.shape[1]}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.paged_attn_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), b,
            hkv, h // hkv, dh, page_size, page_tables.shape[1],
            1.0 / math.sqrt(dh), code, _build.stream_of(q))
    _build.check(rc, "paged_attention")
    return out
