"""Speculative verify: ``Sq`` query tokens per row against a paged KV pool,
with a per-row causal frontier.

q: (B, Sq, H, Dh); token ``i`` of row ``b`` sits at absolute position
``q_offsets[b] + i`` and attends to KV positions ``<= q_offsets[b] + i``
and ``< lengths[b]``. k_pool/v_pool: (NP, page_size, Hkv, Dh) with Hkv
dividing H; page_tables: (B, P) int32 as in ``paged_attn``;
lengths/q_offsets: (B,) int32. Rows of length 0 give exact zeros. The
softmax scale is 1/sqrt(Dh). ``Sq = 1`` with ``q_offsets = lengths - 1``
is decode attention (``paged_attn``). The CUDA kernels are
``csrc/verify.cu`` (they replace ``repro/kernels/verify.py``) and share
their body, page-split plan (``paged_attn.plan_page_splits``) and merge
with the decode kernel; ``paged_verify_attention_plain`` is the same
function in plain PyTorch, ``paged_partials_plain`` the split pass.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attn import (MAX_HEAD_DIM, NEG_INF,
                                            plan_page_splits, split_scratch)


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


def paged_partials_plain(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, page_tables: torch.Tensor,
                         lengths: torch.Tensor, q_offsets: torch.Tensor,
                         bounds):
    """What the split kernel computes for position ranges ``bounds``
    [(start, end), ...] (runs of whole pages, ``PageSplitPlan.bounds(
    page_size)``), in float32: m (S, B, Sq, H) the largest visible scaled
    score of each split (NEG_INF where it sees none), l the sum of
    exp(s - m), o (S, B, Sq, H, Dh) the unnormalised sum of exp(s - m) v.
    ``flash_attn.merge_partials_plain`` combines them."""
    b, sq, h, dh = q.shape
    _, ps, hkv, _ = k_pool.shape
    p = page_tables.shape[1]
    t = page_tables.long()
    kk = k_pool[t].reshape(b, p * ps, hkv, dh).float()
    vv = v_pool[t].reshape(b, p * ps, hkv, dh).float()
    kk = kk.repeat_interleave(h // hkv, dim=2)
    vv = vv.repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum("bqhd,bshd->bqhs", q.float(), kk) / math.sqrt(dh)
    lens = lengths.to(q.device).long()
    kv_pos = torch.arange(p * ps, device=q.device)[None, None, :]
    qpos = q_offsets.to(q.device).long()[:, None, None] \
        + torch.arange(sq, device=q.device)[None, :, None]
    valid = (kv_pos < lens[:, None, None]) & (kv_pos <= qpos)  # (B, Sq, S)
    ms, ls, os_ = [], [], []
    for lo, hi in bounds:
        seen = valid[:, :, None, lo:hi].expand(b, sq, h, hi - lo)
        s = torch.where(seen, logits[..., lo:hi],
                        torch.full_like(logits[..., lo:hi], NEG_INF))
        m = s.amax(-1) if hi > lo else torch.full((b, sq, h), NEG_INF,
                                                  device=q.device)
        e = torch.where(seen, torch.exp(s - m[..., None]),
                        torch.zeros_like(s))
        ms.append(m)
        ls.append(e.sum(-1))
        os_.append(torch.einsum("bqhs,bshd->bqhd", e, vv[:, lo:hi]))
    return torch.stack(ms), torch.stack(ls), torch.stack(os_)


def launch(lib, q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
           page_tables: torch.Tensor, lengths: torch.Tensor,
           q_offsets: torch.Tensor, page_size: int) -> torch.Tensor:
    """Run the CUDA kernels on the current stream (no synchronisation): the
    split kernel over ``plan_page_splits``'s grid, then the merge when the
    plan has more than one split. Reads no tensor on the host. A block's
    shared memory does not grow with Sq * G; refuses Dh above
    MAX_HEAD_DIM."""
    b, sq, h, dh = q.shape
    hkv = k_pool.shape[2]
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"paged_verify_attention kernel supports head_dim "
                         f"<= {MAX_HEAD_DIM}, got {dh}")
    code = _build.check_cuda_args("paged_verify_attention",
                                  (q, k_pool, v_pool),
                                  (page_tables, lengths, q_offsets))
    if page_size != k_pool.shape[1]:
        raise ValueError(f"page_size {page_size} != pool slot axis "
                         f"{k_pool.shape[1]}")
    plan = plan_page_splits(b, sq, h, hkv, page_tables.shape[1], page_size,
                            _build.sm_count(q.device.index))
    out = torch.empty_like(q)
    scratch = split_scratch(plan, b * sq * h, dh, q.device)
    with torch.cuda.device(q.device):
        rc = lib.paged_verify_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_tables.data_ptr(), lengths.data_ptr(), q_offsets.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            b, sq, hkv, h // hkv, dh, page_size, page_tables.shape[1],
            plan.n_splits, plan.pages_per_split, 1.0 / math.sqrt(dh), code,
            _build.stream_of(q))
    _build.check(rc, "paged_verify_attention")
    return out
