"""Flash attention with a causal mask at a run-time absolute offset and an
optional sliding window (the chunked-prefill contract).

q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) with Hkv dividing H; query i of
row b sits at absolute position ``q_offset[b] + i`` (``q_offset`` None:
q is the suffix of kv, Skv - Sq; an int: one offset for every row; a
(B,) int tensor: one per row) and key j at position j. A query whose keys
are all masked gives zeros. The CUDA kernels are ``csrc/flash_attn.cu``
(they replace ``repro/kernels/flash_attn.py``); ``flash_attention_plain``
is the same function in plain PyTorch. The kernel splits the key axis
across blocks (``plan_splits``) and merges the splits in a second pass;
``flash_partials_plain`` and ``merge_partials_plain`` are those two steps
in plain PyTorch.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attn import NEG_INF

ROWS_PER_BLOCK = 32   # (query, head) rows of one KV head per block (kRows)
KEY_TILE = 32         # keys per staged tile (kKeys)
MAX_HEAD_DIM = 256    # the kernel's register tiles cover D <= 256
TARGET_BLOCKS = 132   # the H100's SMs: the plan aims at one block each


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


@dataclass(frozen=True)
class SplitPlan:
    """The key range [kbeg, kend) cut into ``n_splits`` pieces of
    ``split_len`` keys (the last may be shorter); ``row_blocks`` blocks of
    ROWS_PER_BLOCK rows each take every piece."""
    kbeg: int
    kend: int
    n_splits: int
    split_len: int
    row_blocks: int

    @property
    def blocks(self) -> int:
        return self.row_blocks * self.n_splits

    def bounds(self) -> List[Tuple[int, int]]:
        return [(self.kbeg + s * self.split_len,
                 min(self.kbeg + (s + 1) * self.split_len, self.kend))
                for s in range(self.n_splits)]


def plan_splits(b: int, sq: int, skv: int, heads: int, kv_heads: int, *,
                causal: bool, window: Optional[int], q_offset,
                target_blocks: int = TARGET_BLOCKS) -> SplitPlan:
    """Split the keys any query can see across blocks, from the sizes
    alone (no device read), so that there are at least ``target_blocks``
    blocks whenever there are that many (row block, key tile) pairs. An int
    or None offset splits only the visible range; a per-row tensor offset
    splits [0, Skv), and a split that sees no key of its rows writes the
    empty partial. Never an empty grid: no visible key gives one empty
    split (zeros)."""
    row_blocks = b * kv_heads * -(-sq * (heads // kv_heads) // ROWS_PER_BLOCK)
    if isinstance(q_offset, torch.Tensor):
        kbeg, kend = 0, skv
    else:
        off = skv - sq if q_offset is None else int(q_offset)
        kend = max(0, min(skv, off + sq)) if causal else skv
        kbeg = min(max(0, off - window + 1), kend) if window is not None \
            else 0
    tiles = -(-(kend - kbeg) // KEY_TILE)
    if tiles == 0:
        return SplitPlan(kbeg, kend, 1, KEY_TILE, row_blocks)
    per = _tiles_per_split(tiles, row_blocks, target_blocks)
    return SplitPlan(kbeg, kend, -(-tiles // per), per * KEY_TILE,
                     row_blocks)


@functools.lru_cache(maxsize=4096)
def _tiles_per_split(tiles: int, row_blocks: int, target: int) -> int:
    """Key tiles per split. Blocks that share an SM share its shared-memory
    bandwidth, which bounds the kernel, so a call takes about
    ceil(blocks / target) x (tiles per split) tile times: the fewest splits
    that minimise that, among those giving at least ``target`` blocks (one
    tile each when even that gives fewer)."""
    n_min = -(-target // max(row_blocks, 1))
    if tiles <= n_min:
        return 1
    best = (None, 1)
    for n in range(n_min, min(tiles, 4 * n_min) + 1):
        per = -(-tiles // n)
        blocks = row_blocks * -(-tiles // per)
        cost = -(-blocks // target) * per
        if blocks >= target and (best[0] is None or cost < best[0]):
            best = (cost, per)
    return best[1]


def flash_partials_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bounds, *, causal: bool = True,
                         window: Optional[int] = None, q_offset=None):
    """What the split kernel computes for key splits ``bounds`` [(start,
    end), ...], in float32: m (S, B, Sq, H) the largest visible scaled
    score of each split (NEG_INF when it sees none), l the sum of
    exp(s - m), o (S, B, Sq, H, D) the unnormalised sum of exp(s - m) v."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    vis = visibility(q_offset, sq, skv, b, causal, window, q.device)
    kk = k.float().repeat_interleave(h // hkv, dim=2)
    vv = v.float().repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bqhk", q.float(), kk) / math.sqrt(d)
    ms, ls, os_ = [], [], []
    for lo, hi in bounds:
        seen = vis[:, :, None, lo:hi]
        s = torch.where(seen, logits[..., lo:hi],
                        torch.full_like(logits[..., lo:hi], NEG_INF))
        m = s.amax(-1) if hi > lo else torch.full(
            (b, sq, h), NEG_INF, device=q.device)
        p = torch.where(seen, torch.exp(s - m[..., None]),
                        torch.zeros_like(s))
        ms.append(m)
        ls.append(p.sum(-1))
        os_.append(torch.einsum("bqhk,bkhd->bqhd", p, vv[:, lo:hi]))
    return torch.stack(ms), torch.stack(ls), torch.stack(os_)


def merge_partials_plain(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """What the merge kernel computes: o = sum_s e^(m_s - M) o_s / sum_s
    e^(m_s - M) l_s over the splits (M their max), 0 where no split saw a
    key, rounded to ``dtype``."""
    w = torch.exp(m - m.amax(0))
    den = (l * w).sum(0).clamp_min(1e-30)
    return ((o * w[..., None]).sum(0) / den[..., None]).to(dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(lib, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: Optional[int], q_offset) -> torch.Tensor:
    """Run the CUDA kernels on the current stream (no synchronisation): the
    split kernel, then the merge when the plan has more than one split. An
    int (or None) offset is passed by value; a tensor offset must be a (B,)
    int32 CUDA tensor. Refuses D above MAX_HEAD_DIM."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel supports head_dim <= "
                         f"{MAX_HEAD_DIM}, got {d}")
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
    plan = plan_splits(b, sq, skv, h, hkv, causal=causal, window=window,
                       q_offset=q_offset,
                       target_blocks=_sm_count(q.device.index))
    out = torch.empty_like(q)
    scratch = None if plan.n_splits == 1 else torch.empty(
        plan.n_splits * b * sq * h * (d + 2), dtype=torch.float32,
        device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if offsets is None else offsets.data_ptr(), scalar,
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            b, sq, skv, h, hkv, d, int(bool(causal)),
            -1 if window is None else int(window), plan.kbeg, plan.kend,
            plan.n_splits, plan.split_len, 1.0 / math.sqrt(d), code,
            _build.stream_of(q))
    _build.check(rc, "flash_attention")
    return out
