"""Paged-attention decode: one query token per row against a paged KV pool.

q: (B, H, Dh); k_pool/v_pool: (NP, page_size, Hkv, Dh) with Hkv dividing
H; page_tables: (B, P) int32 naming the pages that hold row b's positions
[j*page_size, (j+1)*page_size); lengths: (B,) int32. Positions at or past
lengths[b] are masked; rows of length 0 give exact zeros. The softmax
scale is 1/sqrt(Dh). The CUDA kernels are ``csrc/paged_attn.cu`` (they
replace ``repro/kernels/paged_attn.py``); ``paged_attention_plain`` is the
same function in plain PyTorch. The kernel splits the page table across
blocks (``plan_page_splits``, shared with the verify kernel) and merges
the splits in a second pass; ``paged_partials_plain`` is the first pass
in plain PyTorch, and ``flash_attn.merge_partials_plain`` the second.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Tuple

import torch

from repro_torch.kernels import _build

# Masked score sentinel, as ``kNegInf`` in csrc/common.cuh and the
# reference's attention; the attention plain versions and
# ``models/common.py`` use this one.
NEG_INF = -1e30

ROWS_PER_BLOCK = 32   # (token, head) rows of one KV head per block (kRows)
MAX_HEAD_DIM = 256    # the split kernel's register tiles cover Dh <= 256


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


@dataclass(frozen=True)
class PageSplitPlan:
    """The page table [0, pages) cut into ``n_splits`` runs of
    ``pages_per_split`` whole pages (the last may be shorter);
    ``row_blocks`` blocks of ROWS_PER_BLOCK (token, head) rows each take
    every run."""
    pages: int
    n_splits: int
    pages_per_split: int
    row_blocks: int

    @property
    def blocks(self) -> int:
        return self.row_blocks * self.n_splits

    def bounds(self, page_size: int = 1) -> List[Tuple[int, int]]:
        """Each split's [start, end): pages, or positions with
        ``page_size``."""
        per = self.pages_per_split
        return [(s * per * page_size,
                 min((s + 1) * per, self.pages) * page_size)
                for s in range(self.n_splits)]


def plan_page_splits(b: int, sq: int, heads: int, kv_heads: int, pages: int,
                     page_size: int, target_blocks: int) -> PageSplitPlan:
    """Split the page table of the paged decode and verify kernels across
    blocks, from the sizes alone: ints, never a device tensor, so a launch
    waits on nothing (``lengths`` and ``q_offsets`` stay on the card and
    each block clips its run to its rows' frontier). ``target_blocks`` is
    the card's SM count. Blocks that share an SM share its time, so a
    call takes about ceil(blocks / target) x pages per split page times:
    among the splits giving at least ``target_blocks`` blocks, the least
    of that, ties going to fewer splits (fewer partials to merge); one
    page a split when even that gives fewer blocks. Never an empty grid:
    no page gives one empty split."""
    for name, v in (("b", b), ("sq", sq), ("heads", heads),
                    ("kv_heads", kv_heads), ("pages", pages),
                    ("page_size", page_size),
                    ("target_blocks", target_blocks)):
        if type(v) is not int:
            raise TypeError(f"plan_page_splits: {name} must be an int, got "
                            f"{type(v).__name__}")
    return _plan(b * kv_heads * -(-sq * (heads // kv_heads) // ROWS_PER_BLOCK),
                 pages, target_blocks)


@functools.lru_cache(maxsize=4096)
def _plan(row_blocks: int, pages: int, target_blocks: int) -> PageSplitPlan:
    best = (None, 1)
    for per in range(1, pages + 1):
        blocks = row_blocks * -(-pages // per)
        cost = -(-blocks // target_blocks) * per
        if blocks >= target_blocks and (best[0] is None or cost <= best[0]):
            best = (cost, per)
    return PageSplitPlan(pages, max(-(-pages // best[1]), 1), best[1],
                         row_blocks)


def paged_partials_plain(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, page_tables: torch.Tensor,
                         lengths: torch.Tensor, bounds):
    """What the split kernel computes for position ranges ``bounds``
    [(start, end), ...] (runs of whole pages, ``PageSplitPlan.bounds(
    page_size)``), in float32: m (S, B, H) the largest visible scaled
    score of each split (NEG_INF where it sees none), l the sum of
    exp(s - m), o (S, B, H, Dh) the unnormalised sum of exp(s - m) v.
    ``flash_attn.merge_partials_plain`` combines them."""
    b, h, dh = q.shape
    _, ps, hkv, _ = k_pool.shape
    p = page_tables.shape[1]
    t = page_tables.long()
    kk = k_pool[t].reshape(b, p * ps, hkv, dh).float()
    vv = v_pool[t].reshape(b, p * ps, hkv, dh).float()
    kk = kk.repeat_interleave(h // hkv, dim=2)
    vv = vv.repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum("bhd,bshd->bhs", q.float(), kk) / math.sqrt(dh)
    valid = torch.arange(p * ps, device=q.device)[None, :] \
        < lengths.to(q.device).long()[:, None]
    ms, ls, os_ = [], [], []
    for lo, hi in bounds:
        seen = valid[:, None, lo:hi].expand(b, h, hi - lo)
        s = torch.where(seen, logits[..., lo:hi],
                        torch.full_like(logits[..., lo:hi], NEG_INF))
        m = s.amax(-1) if hi > lo else torch.full((b, h), NEG_INF,
                                                  device=q.device)
        e = torch.where(seen, torch.exp(s - m[..., None]),
                        torch.zeros_like(s))
        ms.append(m)
        ls.append(e.sum(-1))
        os_.append(torch.einsum("bhs,bshd->bhd", e, vv[:, lo:hi]))
    return torch.stack(ms), torch.stack(ls), torch.stack(os_)


def split_scratch(plan: PageSplitPlan, rows: int, dh: int, device):
    """The split partials' scratch for ``rows`` = B * Sq * H output rows:
    None with one split (the kernel writes the output), else o then (m, l)
    for each split, float32."""
    if plan.n_splits == 1:
        return None
    return torch.empty(plan.n_splits * rows * (dh + 2), dtype=torch.float32,
                       device=device)


def launch(lib, q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
           page_tables: torch.Tensor, lengths: torch.Tensor,
           page_size: int) -> torch.Tensor:
    """Run the CUDA kernels on the current stream (no synchronisation): the
    split kernel over ``plan_page_splits``'s grid, then the merge when the
    plan has more than one split. Reads no tensor on the host. Refuses Dh
    above MAX_HEAD_DIM."""
    b, h, dh = q.shape
    hkv = k_pool.shape[2]
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention kernel supports head_dim <= "
                         f"{MAX_HEAD_DIM}, got {dh}")
    code = _build.check_cuda_args("paged_attention", (q, k_pool, v_pool),
                                  (page_tables, lengths))
    if page_size != k_pool.shape[1]:
        raise ValueError(f"page_size {page_size} != pool slot axis "
                         f"{k_pool.shape[1]}")
    plan = plan_page_splits(b, 1, h, hkv, page_tables.shape[1], page_size,
                            _build.sm_count(q.device.index))
    out = torch.empty_like(q)
    scratch = split_scratch(plan, b * h, dh, q.device)
    with torch.cuda.device(q.device):
        rc = lib.paged_attn_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, hkv,
            h // hkv, dh, page_size, page_tables.shape[1], plan.n_splits,
            plan.pages_per_split, 1.0 / math.sqrt(dh), code,
            _build.stream_of(q))
    _build.check(rc, "paged_attention")
    return out
