"""Batched-gather matrix-vector (BGMV) product for multi-LoRA decode:

    y[i] = x[i] @ A[slot(i)] @ B[slot(i)]        i = 0..B-1

x: (B, d_in), A: (S, d_in, R), B: (S, R, d_out), idx: (B,) int32. The
slot rule is the reference's (``slot_index``): a negative idx[i] counts
from the end (S is added), then it is clamped to [0, S - 1]. The rank mask
and the alpha/r_eff scale are the caller's (serve/engine.py).

The CUDA kernel is ``csrc/bgmv.cu`` (it replaces ``repro/kernels/bgmv.py``):
one launch, a thread block cluster of ``plan_bgmv``'s n_splits blocks per
row, block c summing slab c of d_in's rows and writing share c of d_out's
columns, the slabs meeting in slab order over distributed shared memory.
``plan_bgmv`` picks the split from ints and the card's cluster capacity
(``cluster_slots``): the least waves x round trips (``bgmv_trips``: the
passes of A, the merge, the batches of B's rank rows), ties to more
splits. At Gemma-2B's decode (d_in 2048, R 8) that is 8 splits of 256
rows in float32 and one block a row in bfloat16, whose 2048 rows are one
pass. ``bgmv_plain`` is the same function in plain PyTorch. ``ops.bgmv``
picks between them by the tensors' device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

MAX_RANK = 64
# The kernel (csrc/bgmv.cu): THREADS threads a block; a lane takes one
# 16-byte vector (4 float32 or 8 bfloat16 values) of an A row's ranks in
# the rank template (8, 16, 32 or 64), so a block takes THREADS / (template
# / vector) rows a load step and LOADS steps a pass (all of a pass's loads
# in flight). In phase two a lane holds B_ROWS rank rows of B in flight
# (``column_lanes``), the first batch loaded before xa is known. Slabs and
# column shares are multiples of SLAB rows or columns (16 bytes of
# bfloat16); at most MAX_SPLITS blocks a row (the portable cluster size).
THREADS = 256
LOADS = 8
B_ROWS = 8
SLAB = 8
MAX_SPLITS = 8
# the launcher's vec bits: 16-byte loads of x, of A's rows, of B and y
VEC_X, VEC_A, VEC_B = 1, 2, 4


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
    if s == 0:
        raise ValueError("bgmv: no slot to gather from (S = 0)")


def slot_index(idx: torch.Tensor, num_slots: int) -> torch.Tensor:
    """The slots as the reference takes them: idx + S where negative, then
    clamped to [0, S - 1] (int64)."""
    i = idx.long()
    return torch.where(i < 0, i + num_slots, i).clamp(0, num_slots - 1)


def bgmv_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """Gather-einsum reference, float32 accumulation, output in x.dtype."""
    i = slot_index(idx, a.shape[0])
    xa = torch.einsum("bd,bdr->br", x.float(), a[i].float())
    return torch.einsum("br,bro->bo", xa, b[i].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# the plan: slabs of d_in and shares of d_out for one cluster a row
# ---------------------------------------------------------------------------

def rank_template(r: int) -> int:
    """The kernel instantiation a rank runs in: 8, 16, 32 or 64."""
    return next(t for t in (8, 16, 32, 64) if r <= t)


@dataclasses.dataclass(frozen=True)
class BgmvPlan:
    """n_splits blocks a row: block c sums rows [c per, (c + 1) per) of
    d_in and writes columns [c cols, (c + 1) cols) of d_out."""
    batch: int
    d_in: int
    r: int
    d_out: int
    n_splits: int
    rows_per_split: int
    cols_per_split: int

    @property
    def blocks(self) -> int:
        return self.batch * self.n_splits


def _whole(n: int, parts: int) -> int:
    """ceil(n / parts) rounded up to whole SLABs."""
    return -(-(-(-n // parts)) // SLAB) * SLAB


def bgmv_plan(batch: int, d_in: int, r: int, d_out: int, n_splits: int
              ) -> BgmvPlan:
    """d_in cut into at most ``n_splits`` slabs of whole SLABs (fewer
    where the rows run out), d_out into as many shares."""
    if d_in == 0:
        return BgmvPlan(batch, 0, r, d_out, 1, 0, _whole(d_out, 1))
    per = _whole(d_in, n_splits)
    splits = -(-d_in // per)
    return BgmvPlan(batch, d_in, r, d_out, splits, per,
                    _whole(d_out, splits))


def column_lanes(cols_per_split: int, r: int, element_size: int,
                 vec_b: bool = True) -> int:
    """P, the lanes of phase two that share a 16-byte vector of columns
    (each taking ranks q, q + P, ...), as the kernel computes it: the
    least power of two that holds the r ranks in one batch of B_ROWS rank
    rows a lane (``vec_b``: 16-byte loads of B and y), or one rank row a
    lane (element loads, whose scalar loads it shares out), at most a
    warp's 32 lanes and as far as the block's column vectors times P fit
    its THREADS."""
    vecs = cols_per_split // (16 // element_size)
    want = min(32, -(-r // B_ROWS) if vec_b else r)
    lanes = 1
    while lanes < want and vecs * lanes * 2 <= THREADS:
        lanes *= 2
    return lanes


def bgmv_trips(plan: BgmvPlan, element_size: int) -> int:
    """The dependent round trips to memory a block of the plan makes after
    it has read its slot, on the 16-byte path: one a pass of its slab
    (LOADS row steps of A in flight), one for the cluster's merge past one
    split, and one a further batch of B's rank rows past the first (a lane
    holds B_ROWS of them in flight, and the first batch is loaded before xa
    is known)."""
    vec = 16 // element_size
    rows_a_step = THREADS // (rank_template(plan.r) // vec)
    passes = -(-plan.rows_per_split // (rows_a_step * LOADS))
    lanes = column_lanes(plan.cols_per_split, plan.r, element_size)
    col_steps = -(-plan.cols_per_split // (THREADS // lanes * vec))
    batches = -(-plan.r // (B_ROWS * lanes))
    return passes + (plan.n_splits > 1) + col_steps * batches - 1


def bgmv_cost(plan: BgmvPlan, slots: Sequence[int],
              element_size: int) -> float:
    """A plan's waves of blocks times its round trips (a cluster size the
    card cannot hold costs without bound)."""
    held = slots[plan.n_splits - 1]
    if held < plan.n_splits:
        return float("inf")
    return -(-plan.blocks // held) * bgmv_trips(plan, element_size)


def plan_bgmv(batch: int, d_in: int, r: int, d_out: int,
              slots: Sequence[int], element_size: int = 4) -> BgmvPlan:
    """The split of one bgmv call, from ints alone (never a device
    tensor): x (batch, d_in), rank r, d_out, the storage's element size
    (4 or 2 bytes), and ``slots``, the blocks the card holds at once in
    clusters of 1..MAX_SPLITS (``cluster_slots``). The blocks of a plan of
    s splits run in waves of slots[s - 1], and each block makes
    ``bgmv_trips`` round trips: among the cuts into whole SLABs into
    clusters the card can hold, the least waves x trips; ties go to more
    splits (fewer bytes an SM in the same trips)."""
    for name, v in (("batch", batch), ("d_in", d_in), ("r", r),
                    ("d_out", d_out), ("element_size", element_size)):
        if type(v) is not int:
            raise TypeError(f"plan_bgmv: {name} must be an int, got "
                            f"{type(v).__name__}")
    slots = tuple(slots)
    if len(slots) != MAX_SPLITS or any(type(v) is not int for v in slots):
        raise TypeError(f"plan_bgmv: slots must be {MAX_SPLITS} ints, got "
                        f"{slots}")
    if slots[0] < 1:
        raise ValueError(f"plan_bgmv: the card holds no block ({slots})")
    if not 1 <= r <= MAX_RANK or element_size not in (2, 4) \
            or min(batch, d_in, d_out) < 0:
        raise ValueError(f"plan_bgmv: no plan for batch {batch}, d_in "
                         f"{d_in}, r {r}, d_out {d_out}, element size "
                         f"{element_size}")
    return _plan(batch, d_in, r, d_out, slots, element_size)


@functools.lru_cache(maxsize=4096)
def _plan(batch: int, d_in: int, r: int, d_out: int, slots: Tuple[int, ...],
          element_size: int) -> BgmvPlan:
    best = bgmv_plan(batch, d_in, r, d_out, 1)
    cost = bgmv_cost(best, slots, element_size)
    for splits in range(2, min(-(-d_in // SLAB), MAX_SPLITS) + 1):
        plan = bgmv_plan(batch, d_in, r, d_out, splits)
        if plan.n_splits == splits \
                and bgmv_cost(plan, slots, element_size) <= cost:
            best, cost = plan, bgmv_cost(plan, slots, element_size)
    return best


@functools.lru_cache(maxsize=None)
def cluster_slots(lib, index: int, r: int, dtype_code: int
                  ) -> Tuple[int, ...]:
    """The blocks of the bgmv kernel for rank r's template and the dtype
    that CUDA device ``index`` holds at once in clusters of
    1..MAX_SPLITS, as the runtime reports them
    (cudaOccupancyMaxActiveClusters); asked once per library, device,
    template and dtype."""
    with torch.cuda.device(index):
        got = tuple(lib.bgmv_slots(c, rank_template(r), dtype_code)
                    for c in range(1, MAX_SPLITS + 1))
    if any(v < 0 for v in got):
        raise RuntimeError(f"bgmv_slots failed: CUDA error {-min(got)}")
    return got


def vector_flags(element_size: int, d_in: int, r: int, d_out: int,
                 ptrs: Sequence[int]) -> int:
    """The kernel's 16-byte load bits for x, A and (B, y), whose addresses
    (ints) are ``ptrs``: each where its widths are whole vectors and its
    operands 16-byte aligned. Element loads do the same arithmetic."""
    per = 16 // element_size
    px, pa, pb, py = ptrs
    return ((VEC_X if d_in % per == 0 and px % 16 == 0 else 0)
            | (VEC_A if r % per == 0 and pa % 16 == 0 else 0)
            | (VEC_B if d_out % per == 0 and pb % 16 == 0 and py % 16 == 0
               else 0))


def launch(lib, x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           idx: torch.Tensor, plan: Optional[BgmvPlan] = None
           ) -> torch.Tensor:
    """Run the CUDA kernel on the current stream (no synchronisation).
    ``plan`` (default ``plan_bgmv``) names the split, so a check on the
    card can run another split count than the plan's."""
    code = _build.check_cuda_args("bgmv", (x, a, b), (idx,))
    bsz, d_in = x.shape
    s, _, r = a.shape
    d_out = b.shape[2]
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"bgmv kernel supports ranks 1..{MAX_RANK}, got {r}")
    if plan is None:
        plan = plan_bgmv(bsz, d_in, r, d_out, cluster_slots(
            lib, x.device.index, r, code), x.element_size())
    elif (plan.batch, plan.d_in, plan.r, plan.d_out) != (bsz, d_in, r,
                                                          d_out):
        planned = (plan.batch, plan.d_in, plan.r, plan.d_out)
        raise ValueError(f"plan for {planned} given for "
                         f"{(bsz, d_in, r, d_out)}")
    y = torch.empty((bsz, d_out), dtype=x.dtype, device=x.device)
    vec = vector_flags(x.element_size(), d_in, r, d_out,
                       (x.data_ptr(), a.data_ptr(), b.data_ptr(),
                        y.data_ptr()))
    with torch.cuda.device(x.device):
        rc = lib.bgmv_launch(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), idx.data_ptr(),
            y.data_ptr(), bsz, d_in, r, d_out, s, plan.n_splits,
            plan.rows_per_split, plan.cols_per_split, vec, code,
            _build.stream_of(x))
    _build.check(rc, "bgmv")
    return y
