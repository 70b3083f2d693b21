"""Speculative verify: ``Sq`` query tokens per row against a paged KV pool,
with a per-row causal frontier.

q: (B, Sq, H, Dh); token ``i`` of row ``b`` sits at absolute position
``q_offsets[b] + i`` and attends to KV positions ``<= q_offsets[b] + i``
and ``< lengths[b]``. k_pool/v_pool: (NP, page_size, Hkv, Dh) with Hkv
dividing H; page_tables: (B, P) int32 as in ``paged_attn``;
lengths/q_offsets: (B,) int32. Rows of length 0 give exact zeros. The
softmax scale is 1/sqrt(Dh). ``Sq = 1`` with ``q_offsets = lengths - 1``
is decode attention (``paged_attn``). The CUDA kernel is ``csrc/verify.cu``
(it replaces ``repro/kernels/verify.py``); ``paged_verify_attention_plain``
is the same function in plain PyTorch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attn import NEG_INF

# The most dynamic shared memory one block may use on sm_90 (as
# ``kMaxSmemBytes`` in csrc/common.cuh).
MAX_SMEM_BYTES = 232448


def validate(q, k_pool, v_pool, page_tables, lengths, q_offsets) -> None:
    if q.ndim != 4 or k_pool.ndim != 4 or page_tables.ndim != 2 \
            or lengths.ndim != 1 or q_offsets.ndim != 1:
        raise ValueError(
            f"paged_verify_attention expects q (B, Sq, H, Dh), pools (NP, "
            f"ps, Hkv, Dh), tables (B, P), lengths and q_offsets (B,); got "
            f"{tuple(q.shape)} {tuple(k_pool.shape)} "
            f"{tuple(page_tables.shape)} {tuple(lengths.shape)} "
            f"{tuple(q_offsets.shape)}")
    b, _, h, dh = q.shape
    _, _, hkv, pdh = k_pool.shape
    if v_pool.shape != k_pool.shape or pdh != dh or h % hkv \
            or page_tables.shape[0] != b or lengths.shape[0] != b \
            or q_offsets.shape[0] != b:
        raise ValueError(
            f"paged_verify_attention shape mismatch: q {tuple(q.shape)} "
            f"k_pool {tuple(k_pool.shape)} v_pool {tuple(v_pool.shape)} "
            f"tables {tuple(page_tables.shape)} lengths "
            f"{tuple(lengths.shape)} q_offsets {tuple(q_offsets.shape)}")


def paged_verify_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 page_tables: torch.Tensor,
                                 lengths: torch.Tensor,
                                 q_offsets: torch.Tensor) -> torch.Tensor:
    """Gather the row's pages, mask at the length and the per-token causal
    frontier, softmax in float32."""
    b, sq, h, dh = q.shape
    _, ps, hkv, _ = k_pool.shape
    p = page_tables.shape[1]
    t = page_tables.long()
    groups = h // hkv
    kk = k_pool[t].reshape(b, p * ps, hkv, dh).float()
    vv = v_pool[t].reshape(b, p * ps, hkv, dh).float()
    kk = kk.repeat_interleave(groups, dim=2)        # head h*G+g <- kv head h
    vv = vv.repeat_interleave(groups, dim=2)
    logits = torch.einsum("bqhd,bshd->bqhs", q.float(), kk) / math.sqrt(dh)
    lens = lengths.to(q.device).long()
    kv_pos = torch.arange(p * ps, device=q.device)[None, None, :]
    qpos = q_offsets.to(q.device).long()[:, None, None] \
        + torch.arange(sq, device=q.device)[None, :, None]
    valid = (kv_pos < lens[:, None, None]) & (kv_pos <= qpos)  # (B, Sq, S)
    logits = torch.where(valid[:, :, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    out = torch.einsum("bqhs,bshd->bqhd", torch.softmax(logits, -1), vv)
    # empty rows give exact zeros, not a fully-masked softmax's uniform mix
    out = out * (lens > 0)[:, None, None, None]
    return out.to(q.dtype)


def smem_bytes(sq: int, groups: int, dh: int, page_size: int) -> int:
    """Dynamic shared memory of one block of ``csrc/verify.cu``: q and the
    accumulator for its Sq*G query rows, one page of K and V, the page's
    scores and three softmax statistics per query row, all float32."""
    rows = sq * groups
    return 4 * (2 * rows * dh + 2 * page_size * dh + rows * page_size
                + 3 * rows)


def launch(lib, q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
           page_tables: torch.Tensor, lengths: torch.Tensor,
           q_offsets: torch.Tensor, page_size: int) -> torch.Tensor:
    """Run the CUDA kernel on the current stream (no synchronisation).
    Raises, and launches nothing, for a shape whose block does not fit the
    card's shared memory."""
    b, sq, h, dh = q.shape
    hkv = k_pool.shape[2]
    if page_size != k_pool.shape[1]:
        raise ValueError(f"page_size {page_size} != pool slot axis "
                         f"{k_pool.shape[1]}")
    need = smem_bytes(sq, h // hkv, dh, page_size)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"paged_verify_attention: Sq*G = {sq * (h // hkv)} query rows "
            f"of Dh {dh} with page_size {page_size} need {need} bytes of "
            f"shared memory per block, more than the {MAX_SMEM_BYTES} one "
            f"block may use")
    code = _build.check_cuda_args("paged_verify_attention",
                                  (q, k_pool, v_pool),
                                  (page_tables, lengths, q_offsets))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.paged_verify_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_tables.data_ptr(), lengths.data_ptr(), q_offsets.data_ptr(),
            out.data_ptr(), b, sq, hkv, h // hkv, dh, page_size,
            page_tables.shape[1], 1.0 / math.sqrt(dh), code,
            _build.stream_of(q))
    _build.check(rc, "paged_verify_attention")
    return out
