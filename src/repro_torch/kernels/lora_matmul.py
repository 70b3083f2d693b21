"""Fused LoRA matmul for client training, forward and backward:

    forward   y  = x @ W0 + s * (x @ A) @ B          (and xa = x @ A)
    dx        dx = dy @ W0^T + s * g @ A^T,  g = dy @ B^T
    dA, dB    dA = s * x^T g,  dB = s * xa^T dy

x: (M, K), W0: (K, N), A: (K, R), B: (R, N), dy: (M, N); s a float32
scalar tensor. The forward takes float32 or bfloat16 (float64 on the
CPU); the backward refuses bfloat16, as bf16 training is not ported. The
CUDA kernels are ``csrc/lora_matmul.cu`` (they replace
``repro/kernels/lora_matmul.py``, which had no backward); the ``*_plain``
functions are the same arithmetic in plain PyTorch. ``ops`` picks between
them by the tensors' device.

On CUDA the forward and dx run in two or three kernels: the bottleneck
(xa or g) once per row, then one tile GEMM that takes the low-rank term
as R more reduction steps, over a reduction split chosen by
``plan_splits``, then, with more than one split, a merge of the split
partials in split order. ``split_product_plain`` is that decomposition in
plain PyTorch.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

MAX_RANK = 64
TILE = (64, 64)              # the tile GEMM's output rows and columns a block
DEPTH = 16                   # reduction steps a stage; splits are multiples
MAX_ROWS = 65535 * TILE[0]   # grid.y covers the row tiles
MAX_SPLITS = 65535           # grid.z
# Tile GEMM blocks an SM holds: 256 threads at the kernel's launch bounds
# of 128 registers or fewer (two blocks take the 64 K-register file), 48
# KB of shared memory each.
BLOCKS_PER_SM = 2


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


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """The tile GEMM's grid for an (m, n) output over a reduction of depth
    k: TILE-sized output tiles, and the reduction in ``n_splits`` ranges
    of ``k_per_split`` (a multiple of DEPTH; the last may be shorter).
    Split 0 also takes the low-rank term."""
    m: int
    n: int
    k: int
    n_splits: int
    k_per_split: int

    @property
    def tiles_m(self) -> int:
        return -(-self.m // TILE[0])

    @property
    def tiles_n(self) -> int:
        return -(-self.n // TILE[1])

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.tiles_n * self.n_splits

    def bounds(self) -> List[Tuple[int, int]]:
        """Each split's reduction range [lo, hi), in split order."""
        per = self.k_per_split
        return [(s * per, min(self.k, (s + 1) * per))
                for s in range(self.n_splits)]


def split_plan(m: int, n: int, k: int, n_splits: int) -> SplitPlan:
    """The reduction cut into at most ``n_splits`` ranges of whole stages
    (fewer where the depth runs out)."""
    if k == 0:
        return SplitPlan(m, n, 0, 1, 0)
    per = -(-k // n_splits)                       # ceil(k / n_splits) ...
    per = -(-per // DEPTH) * DEPTH                # ... in whole stages
    return SplitPlan(m, n, k, -(-k // per), per)


def plan_splits(m: int, n: int, k: int, sms: int) -> SplitPlan:
    """The reduction split of one forward or dx call, from the sizes alone
    (ints, never a device tensor: a launch waits on nothing): the output
    (m, n), the reduction depth k, and the card's SM count. The blocks run
    in waves of BLOCKS_PER_SM an SM, so a call takes about
    ceil(blocks / (BLOCKS_PER_SM * sms)) x k_per_split stage times
    (``plan_cost``). Among the splits into whole stages, up to four times
    the fewest that give every SM its blocks (as ``flash_attn``'s plan),
    the least of that; ties go to fewer splits (fewer partials to
    merge)."""
    for name, v in (("m", m), ("n", n), ("k", k), ("sms", sms)):
        if type(v) is not int:
            raise TypeError(f"plan_splits: {name} must be an int, got "
                            f"{type(v).__name__}")
    return _plan(m, n, k, sms)


def plan_cost(plan: SplitPlan, sms: int) -> int:
    """A plan's waves of blocks times its depth a split."""
    return -(-plan.blocks // (BLOCKS_PER_SM * sms)) * plan.k_per_split


@functools.lru_cache(maxsize=4096)
def _plan(m: int, n: int, k: int, sms: int) -> SplitPlan:
    tiles = split_plan(m, n, k, 1).blocks
    most = 4 * -(-BLOCKS_PER_SM * sms // max(tiles, 1))
    best = None
    for splits in range(1, min(-(-k // DEPTH), most, MAX_SPLITS) + 1):
        plan = split_plan(m, n, k, splits)
        if plan.n_splits != splits:
            continue                        # the same ranges as fewer splits
        cost = plan_cost(plan, sms)
        if best is None or cost < best[0]:
            best = (cost, plan)
    return best[1] if best else split_plan(m, n, k, 1)


def vector_loads(element_size: int, k: int, n: int,
                 ptrs: Sequence[int]) -> bool:
    """Whether the tile GEMM may use 16-byte loads and stores: the
    reduction depth k and the output width n multiples of the elements in
    16 bytes, and every operand's address (ints) 16-byte aligned. The
    launcher passes the result; the kernel with element loads does the
    same arithmetic in the same order."""
    per = 16 // element_size
    return k % per == 0 and n % per == 0 and all(p % 16 == 0 for p in ptrs)


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


def split_product_plain(p: torch.Tensor, q: torch.Tensor,
                        p_ext: torch.Tensor, q_ext: torch.Tensor,
                        plan: SplitPlan) -> torch.Tensor:
    """The tile GEMM's decomposition: p (m, k) @ q (k, n) as one partial
    per split of ``plan.bounds()``, split 0 with the low-rank term as R
    more reduction steps ([p | p_ext] against [q ; q_ext]), the partials
    summed in split order."""
    parts = []
    for s, (lo, hi) in enumerate(plan.bounds()):
        pp, qq = p[:, lo:hi], q[lo:hi]
        if s == 0:
            pp, qq = torch.cat([pp, p_ext], 1), torch.cat([qq, q_ext], 0)
        parts.append(pp @ qq)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def lora_matmul_split_plain(x, w0, a, b, scale, plan: SplitPlan
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, xa) as the CUDA forward decomposes them under ``plan``."""
    xa = _acc(x) @ _acc(a)
    y = split_product_plain(_acc(x), _acc(w0), scale * xa, _acc(b), plan)
    return y.to(x.dtype), xa


def lora_matmul_dx_split_plain(dy, w0, a, b, scale, plan: SplitPlan
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, g) as the CUDA dx decomposes them under ``plan``."""
    g = _acc(dy) @ _acc(b).T
    dx = split_product_plain(_acc(dy), _acc(w0).T, scale * g, _acc(a).T,
                             plan)
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


def partials(plan: SplitPlan, device) -> Optional[torch.Tensor]:
    """The split partials' float32 scratch: None with one split (the GEMM
    writes the output)."""
    if plan.n_splits == 1:
        return None
    return torch.empty(plan.n_splits * plan.m * plan.n, dtype=torch.float32,
                       device=device)


def _plan_for(plan: Optional[SplitPlan], m: int, n: int, k: int,
              device) -> SplitPlan:
    if plan is None:
        return plan_splits(m, n, k, _build.sm_count(device.index))
    if (plan.m, plan.n, plan.k) != (m, n, k):
        raise ValueError(f"plan for {(plan.m, plan.n, plan.k)} given for "
                         f"{(m, n, k)}")
    return plan


def launch(lib, x, w0, a, b, scale, return_xa: bool = False,
           plan: Optional[SplitPlan] = None):
    """The forward kernels: y, or (y, xa) with ``return_xa``. ``plan``
    (default ``plan_splits``) names the split, so a check on the card can
    run another split count than the plan's."""
    code = _build.check_cuda_args("lora_matmul", (x, w0, a, b))
    _check_f32("lora_matmul", x, scale)
    m, k = x.shape
    n, r = w0.shape[1], a.shape[1]
    plan = _plan_for(plan, m, n, k, x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    xa = torch.empty((m, r), dtype=torch.float32, device=x.device)
    part = partials(plan, x.device)
    vec = vector_loads(x.element_size(), k, n,
                       (x.data_ptr(), w0.data_ptr(), y.data_ptr()))
    with torch.cuda.device(x.device):
        rc = lib.lora_matmul_launch(
            x.data_ptr(), w0.data_ptr(), a.data_ptr(), b.data_ptr(),
            scale.data_ptr(), y.data_ptr(), xa.data_ptr(),
            None if part is None else part.data_ptr(), m, n, k, r, 0, 1,
            plan.n_splits, plan.k_per_split, int(vec), code,
            _build.stream_of(x))
    _build.check(rc, "lora_matmul")
    return (y, xa) if return_xa else y


def launch_dx(lib, dy, w0, a, b, scale, need_dx: bool = True,
              plan: Optional[SplitPlan] = None):
    """The dx kernels with W0, A and B read transposed: (dx or None, g).
    Without ``need_dx`` it computes g alone (no W0 product). ``plan`` as
    for ``launch``, over the output (M, K) and the reduction N."""
    code = _build.check_cuda_args("lora_matmul_dx", (dy, w0, a, b))
    _check_f32("lora_matmul_dx", dy, scale)
    m, n = dy.shape
    k, r = w0.shape[0], a.shape[1]
    g = torch.empty((m, r), dtype=torch.float32, device=dy.device)
    dx = part = None
    splits = per = vec = 0
    if need_dx:
        plan = _plan_for(plan, m, k, n, dy.device)
        dx = torch.empty((m, k), dtype=dy.dtype, device=dy.device)
        part = partials(plan, dy.device)
        splits, per = plan.n_splits, plan.k_per_split
        vec = int(vector_loads(dy.element_size(), n, k,
                               (dy.data_ptr(), w0.data_ptr(), dx.data_ptr())))
    # in = dy (M, N): W' = W0^T, down = B^T (B stored (R, N)), up = A^T
    with torch.cuda.device(dy.device):
        rc = lib.lora_matmul_launch(
            dy.data_ptr(), w0.data_ptr(), b.data_ptr(), a.data_ptr(),
            scale.data_ptr(), dx.data_ptr() if need_dx else None,
            g.data_ptr(), None if part is None else part.data_ptr(), m, k,
            n, r, 1, int(need_dx), splits, per, vec, code,
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
