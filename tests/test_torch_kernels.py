"""The port's kernel entry points on the CPU against the reference.

On the CPU ``repro_torch.kernels.ops`` runs each kernel's plain PyTorch
version; here those are held to the reference's jnp oracles
(``repro.kernels.ref``) and to its Pallas kernels in interpret mode
(``repro.kernels.ops``), on the same numpy inputs. The CUDA kernels
themselves run only on the GPU (``chip_smoke.py``); what is checked of
them here is that a CPU tensor never reaches them and that their launch
wrappers refuse what the kernels do not take.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.common import _repeat_kv as j_repeat_kv
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import bgmv as bgmv_mod
from repro_torch.kernels import flash_attn as flash_mod
from repro_torch.kernels import lora_matmul as lora_mod
from repro_torch.kernels import paged_attn as paged_mod

# float32 on both sides; the products are summed in another order, so
# results agree to a few ulp of O(1) values.
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread avoids thread-pool
    overhead and contention with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("bsz,slots,d_in,r,d_out,seed", [
    (5, 3, 48, 8, 40, 0),
    (8, 4, 64, 16, 24, 1),
])
def test_bgmv_plain_matches_reference(bsz, slots, d_in, r, d_out, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, d_in), dtype=np.float32)
    mask = (np.arange(r)[None, :] < rng.integers(1, r + 1, slots)[:, None])
    a = (rng.standard_normal((slots, d_in, r), dtype=np.float32)
         * mask[:, None, :]).astype(np.float32)
    b = rng.standard_normal((slots, r, d_out), dtype=np.float32)
    idx = rng.integers(0, slots, bsz).astype(np.int32)
    got = ops.bgmv(_t(x), _t(a), _t(b), _t(idx)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.bgmv_ref(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx))),
        **TOL)
    np.testing.assert_allclose(got, np.asarray(jops.bgmv(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx),
        interpret=True)), **TOL)


def _lora_inputs(seed, m, k, n, r):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w0 = rng.standard_normal((k, n), dtype=np.float32) / np.sqrt(k)
    a = rng.standard_normal((k, r), dtype=np.float32) / np.sqrt(k)
    b = rng.standard_normal((r, n), dtype=np.float32) * 0.1
    return x, w0.astype(np.float32), a.astype(np.float32), b


# ragged M, K and N (no multiple of the kernels' 64/16 tiles or of the
# reference's 128-lane blocks), each rank 1..8
@pytest.mark.parametrize("m,k,n,r", [
    (37, 50, 70, 1), (37, 50, 70, 2), (64, 48, 96, 3), (5, 129, 33, 4),
    (100, 64, 64, 5), (1, 40, 24, 6), (70, 33, 130, 7), (48, 96, 80, 8),
])
def test_lora_matmul_plain_matches_reference_and_pallas(m, k, n, r):
    x, w0, a, b = _lora_inputs(m + k + r, m, k, n, r)
    scale = 16.0 / r
    got = ops.lora_matmul(_t(x), _t(w0), _t(a), _t(b), scale).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.lora_matmul_ref(
        jnp.asarray(x), jnp.asarray(w0), jnp.asarray(a), jnp.asarray(b),
        scale)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jops.lora_matmul(
        jnp.asarray(x), jnp.asarray(w0), jnp.asarray(a), jnp.asarray(b),
        scale, interpret=True)), **TOL)
    # the bottleneck the backward keeps, and the same y beside it
    y2, xa = ops.lora_matmul(_t(x), _t(w0), _t(a), _t(b), scale,
                             return_xa=True)
    np.testing.assert_array_equal(y2.numpy(), got)
    np.testing.assert_allclose(xa.numpy(), x @ a, **TOL)


def test_lora_matmul_backward_ops_match_their_formulas():
    """dx, g, dA and dB of the ops against the chain rule in float64."""
    x, w0, a, b = _lora_inputs(3, 21, 30, 26, 5)
    dy = np.random.default_rng(4).standard_normal((21, 26)).astype(np.float32)
    s = 3.2
    dx, g = ops.lora_matmul_dx(_t(dy), _t(w0), _t(a), _t(b), s)
    none, g2 = ops.lora_matmul_dx(_t(dy), _t(w0), _t(a), _t(b), s,
                                  need_dx=False)
    assert none is None and torch.equal(g, g2)
    _, xa = ops.lora_matmul(_t(x), _t(w0), _t(a), _t(b), s, return_xa=True)
    da, db = ops.lora_matmul_grad_ab(_t(x), xa, _t(dy), g, s)
    x64, w64, a64, b64, dy64 = (v.astype(np.float64)
                                for v in (x, w0, a, b, dy))
    g64 = dy64 @ b64.T
    np.testing.assert_allclose(g.numpy(), g64, **TOL)
    np.testing.assert_allclose(dx.numpy(), dy64 @ w64.T + s * g64 @ a64.T,
                               **TOL)
    np.testing.assert_allclose(da.numpy(), s * x64.T @ g64, **TOL)
    np.testing.assert_allclose(db.numpy(), s * (x64 @ a64).T @ dy64, **TOL)


def test_lora_matmul_backward_refuses_bf16():
    """bf16 training is not ported: the backward ops (and so a bf16
    ``apply_lora`` that needs a gradient) raise, on any device, before any
    kernel; the bf16 forward stays."""
    from repro_torch.core import lora as lora_lib
    x, w0, a, b = (torch.from_numpy(v).to(torch.bfloat16)
                   for v in _lora_inputs(3, 6, 8, 5, 2))
    dy = torch.ones(6, 5, dtype=torch.bfloat16)
    xa = torch.zeros(6, 2)
    assert ops.lora_matmul(x, w0, a, b, 1.0).dtype == torch.bfloat16
    with pytest.raises(TypeError, match="bf16 training"):
        ops.lora_matmul_dx(dy, w0, a, b, 1.0)
    with pytest.raises(TypeError, match="bf16 training"):
        ops.lora_matmul_grad_ab(x, xa, dy, xa, 1.0)
    adapter = {"A": a.float().requires_grad_(True), "B": b.float(),
               "mask": torch.ones(2)}
    y = lora_lib.apply_lora(x, w0, adapter, 4.0)
    with pytest.raises(TypeError, match="bf16 training"):
        y.sum().backward()


def _paged_inputs(seed, bsz, hkv, groups, dh, ps, pages, lengths):
    rng = np.random.default_rng(seed)
    n_pool = bsz * pages
    q = rng.standard_normal((bsz, hkv * groups, dh), dtype=np.float32)
    kp = rng.standard_normal((n_pool + 1, ps, hkv, dh), dtype=np.float32)
    vp = rng.standard_normal((n_pool + 1, ps, hkv, dh), dtype=np.float32)
    tables = rng.permutation(n_pool).reshape(bsz, pages).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("hkv,groups,dh,ps,pages,lengths", [
    (2, 3, 16, 5, 3, [0, 1, 7, 15]),        # page size not a multiple of 8
    (1, 4, 32, 8, 4, [3, 0, 32, 17, 9]),   # MQA, full and partial pages
])
def test_paged_attention_plain_matches_reference(hkv, groups, dh, ps, pages,
                                                 lengths):
    q, kp, vp, tables, lens = _paged_inputs(7, len(lengths), hkv, groups,
                                            dh, ps, pages, lengths)
    got = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(lens),
                              page_size=ps).numpy()
    args = [jnp.asarray(a) for a in (q, kp, vp, tables, lens)]
    np.testing.assert_allclose(
        got, np.asarray(jref.paged_attention_ref(*args)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jops.paged_attention(*args, page_size=ps,
                                             interpret=True)), **TOL)
    assert not got[lens == 0].any()          # empty rows: exact zeros


@pytest.mark.parametrize("q_offset,window", [
    (5, None),               # chunked prefill: scalar absolute offset
    ((3, 16), None),         # one offset per row
    (5, 4),                  # sliding window
])
def test_flash_attention_plain_matches_pallas_interpret(q_offset, window):
    rng = np.random.default_rng(11)
    b, sq, h, hkv, d, skv = 2, 8, 4, 2, 16, 24
    q = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, skv, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, skv, hkv, d), dtype=np.float32)
    off_t = (torch.tensor(q_offset, dtype=torch.int32)
             if isinstance(q_offset, tuple) else q_offset)
    off_j = (jnp.asarray(q_offset, jnp.int32)
             if isinstance(q_offset, tuple) else q_offset)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              window=window, q_offset=off_t).numpy()
    # the Pallas kernel takes as many KV heads as query heads
    kk = j_repeat_kv(jnp.asarray(k), h // hkv)
    vv = j_repeat_kv(jnp.asarray(v), h // hkv)
    want = jops.flash_attention(jnp.asarray(q), kk, vv, causal=True,
                                window=window, q_offset=off_j,
                                interpret=True, block_q=8, block_k=8)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [None, 5])
def test_flash_attention_plain_matches_jnp_reference_suffix(window):
    """q_offset=None: the queries are the suffix of the keys, the
    contract of ``repro.kernels.ref.flash_attention_ref``."""
    rng = np.random.default_rng(3)
    sq, h, d, skv = 6, 2, 8, 10
    q = rng.standard_normal((sq, h, d), dtype=np.float32)
    k = rng.standard_normal((skv, h, d), dtype=np.float32)
    v = rng.standard_normal((skv, h, d), dtype=np.float32)
    got = ref.flash_attention_ref(_t(q)[None], _t(k)[None], _t(v)[None],
                                  causal=True, window=window)[0].numpy()
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    window=window)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_flash_attention_all_masked_queries_give_zeros():
    """A query that sees no key gives zeros (the kernel's l clamp), where
    a fully-masked softmax would mix every value uniformly."""
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((1, 4, 2, 8), dtype=np.float32))
    k = _t(rng.standard_normal((1, 6, 1, 8), dtype=np.float32))
    out = ops.flash_attention(q, k, k, causal=True, window=2, q_offset=7)
    # positions 7..10 against keys 0..5 with window 2: only query 0 (pos
    # 7) could reach key 6, which does not exist -> every row is empty
    assert torch.count_nonzero(out) == 0
    part = ops.flash_attention(q, k, k, causal=True, window=2, q_offset=5)
    assert torch.count_nonzero(part[0, 0]) > 0      # pos 5 sees keys 4, 5
    assert torch.count_nonzero(part[0, 2:]) == 0    # pos 7, 8 see none


# The split plan of the CUDA flash kernel and the plain versions of its two
# passes (split partials, merge). Cases: (B, Sq, Skv, H, Hkv, q_offset,
# window); a tuple offset is one per row (a tensor).
PLAN_CASES = [
    (1, 64, 208, 8, 1, 128, None),        # the engine's prefill chunk
    (1, 64, 2048, 8, 1, 1984, None),      # the last chunk of a 2k prompt
    (1, 64, 208, 8, 1, 128, 48),          # with a window
    (2, 64, 208, 8, 1, (0, 100), None),   # per-row offsets
    (2, 13, 77, 6, 2, (3, 40), 9),        # ragged, per-row, window
    (1, 7, 50, 4, 4, None, None),         # suffix, ragged
    (2, 5, 33, 3, 1, None, 4),            # suffix, window
    (1, 600, 600, 8, 1, None, None),      # rows alone fill the card
    (1, 6, 20, 2, 1, -3, None),           # queries 0..2 see no key
    (2, 3, 9, 2, 1, 40, None),            # offset past the keys
]


def _offset(q_offset):
    return (torch.tensor(q_offset, dtype=torch.int32)
            if isinstance(q_offset, tuple) else q_offset)


@pytest.mark.parametrize("target", [132, 8])
@pytest.mark.parametrize("case", PLAN_CASES)
def test_flash_split_plan_covers_each_visible_key_once(case, target):
    b, sq, skv, h, hkv, q_offset, window = case
    off = _offset(q_offset)
    plan = flash_mod.plan_splits(b, sq, skv, h, hkv, causal=True,
                                 window=window, q_offset=off,
                                 target_blocks=target)
    assert plan.n_splits >= 1 and plan.blocks >= 1   # never an empty grid
    assert plan.row_blocks == b * hkv * -(-sq * (h // hkv)
                                          // flash_mod.ROWS_PER_BLOCK)
    bounds = plan.bounds()
    assert all(0 <= lo < hi <= skv for lo, hi in bounds) or \
        bounds == [(plan.kbeg, plan.kend)]
    count = torch.zeros(skv, dtype=torch.long)
    for lo, hi in bounds:
        count[lo:hi] += 1
    vis = flash_mod.visibility(off, sq, skv, b, True, window, "cpu")
    seen = vis.any(0).any(0)
    assert bool((count[seen] == 1).all())            # each exactly once
    assert int(count.max()) <= 1
    if isinstance(off, torch.Tensor):                # no device read
        assert (plan.kbeg, plan.kend) == (0, skv)
    else:                                            # the visible range only
        assert not bool(seen[:plan.kbeg].any()) and \
            not bool(seen[plan.kend:].any())
    tiles = -(-(plan.kend - plan.kbeg) // flash_mod.KEY_TILE)
    if plan.row_blocks * tiles >= target:            # when the work allows
        assert plan.blocks >= target
    else:
        assert plan.n_splits == max(tiles, 1)


@pytest.mark.parametrize("case", PLAN_CASES)
def test_flash_merge_plain_of_the_plan_equals_plain_attention(case):
    b, sq, skv, h, hkv, q_offset, window = case
    off = _offset(q_offset)
    rng = np.random.default_rng(sq * 1000 + skv)
    q, k, v = (_t(rng.standard_normal(shape, dtype=np.float32))
               for shape in ((b, sq, h, 8), (b, skv, hkv, 8),
                             (b, skv, hkv, 8)))
    plan = flash_mod.plan_splits(b, sq, skv, h, hkv, causal=True,
                                 window=window, q_offset=off)
    kw = dict(causal=True, window=window, q_offset=off)
    m, l, o = flash_mod.flash_partials_plain(q, k, v, plan.bounds(), **kw)
    got = flash_mod.merge_partials_plain(m, l, o, torch.float32)
    torch.testing.assert_close(
        got, flash_mod.flash_attention_plain(q, k, v, **kw), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("bounds", [
    [(0, 24)],                               # one split
    [(0, 5), (5, 6), (6, 24)],               # uneven
    [(0, 7), (7, 7), (7, 16), (16, 24)],     # an empty split
    [(0, 3), (3, 12), (12, 20), (20, 24)],   # splits past every frontier
    [(i, i + 1) for i in range(24)],         # one key each
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_merge_plain_equals_plain_attention_any_splits(bounds, dtype):
    """Merging the partials of arbitrary key splits gives the plain
    attention within 1e-6 (float32 sums in another order); queries that
    see no key (offset -4: queries 0..3; window 3 with per-row offsets)
    give exact zeros; bf16 rounds the merged float32 result once."""
    rng = np.random.default_rng(len(bounds))
    b, sq, h, hkv, d, skv = 2, 10, 4, 2, 16, 24
    q, k, v = (_t(rng.standard_normal(shape, dtype=np.float32)).to(dtype)
               for shape in ((b, sq, h, d), (b, skv, hkv, d),
                             (b, skv, hkv, d)))
    for kw in (dict(causal=True, window=None, q_offset=-4),
               dict(causal=True, window=3,
                    q_offset=torch.tensor([-2, 9], dtype=torch.int32)),
               dict(causal=True, window=None, q_offset=None)):
        m, l, o = flash_mod.flash_partials_plain(q, k, v, bounds, **kw)
        got = flash_mod.merge_partials_plain(m, l, o, dtype)
        want = flash_mod.flash_attention_plain(q, k, v, **kw)
        assert got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        else:   # one bf16 ulp of each element
            err = (got.float() - want.float()).abs()
            assert bool((err <= 2.0 ** -7 * want.float().abs() + 1e-6).all())
        vis = flash_mod.visibility(kw["q_offset"], sq, skv, b, True,
                                   kw["window"], "cpu").any(-1)
        assert bool((~vis).any()) or kw["q_offset"] is None
        assert torch.count_nonzero(got[~vis]) == 0


def test_cpu_tensors_run_the_plain_versions_without_building(monkeypatch):
    def no_build():
        raise AssertionError("a CPU call must not build or load kernels")

    monkeypatch.setattr(_build, "load", no_build)
    before = dict(ops.LAUNCHES)
    x = torch.randn(3, 8)
    a, b = torch.randn(2, 8, 4), torch.randn(2, 4, 5)
    idx = torch.tensor([0, 1, 1], dtype=torch.int32)
    torch.testing.assert_close(ops.bgmv(x, a, b, idx),
                               bgmv_mod.bgmv_plain(x, a, b, idx))
    q = torch.randn(2, 4, 4, 8)
    kv = torch.randn(2, 5, 2, 8)
    torch.testing.assert_close(
        ops.flash_attention(q, kv, kv, q_offset=2),
        flash_mod.flash_attention_plain(q, kv, kv, q_offset=2))
    w0, a, b = torch.randn(8, 6), torch.randn(8, 3), torch.randn(3, 6)
    y, xa = ops.lora_matmul(x, w0, a, b, torch.tensor(2.0), return_xa=True)
    torch.testing.assert_close(y, lora_mod.lora_matmul_plain(x, w0, a, b,
                                                             2.0))
    dx, g = ops.lora_matmul_dx(torch.randn(3, 6), w0, a, b, 2.0)
    ops.lora_matmul_grad_ab(x, xa, torch.randn(3, 6), g, 2.0)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("call", [
    lambda: ops.bgmv(torch.randn(3, 8), torch.randn(2, 7, 4),
                     torch.randn(2, 4, 5), torch.zeros(3, dtype=torch.int32)),
    lambda: ops.paged_attention(torch.randn(2, 3, 8),
                                torch.randn(5, 4, 2, 8),
                                torch.randn(5, 4, 2, 8),
                                torch.zeros(2, 2, dtype=torch.int32),
                                torch.zeros(2, dtype=torch.int32),
                                page_size=4),
    lambda: ops.flash_attention(torch.randn(1, 4, 3, 8),
                                torch.randn(1, 6, 2, 8),
                                torch.randn(1, 6, 2, 8)),
    lambda: ops.flash_attention(torch.randn(1, 4, 2, 8),
                                torch.randn(1, 6, 2, 8),
                                torch.randn(1, 6, 2, 8), window=0),
    # lora_matmul: K mismatch, B's rank, rank 0, rank past the kernel's 64,
    # a scale of two values, dy's width, xa's rows
    lambda: ops.lora_matmul(torch.randn(3, 8), torch.randn(7, 5),
                            torch.randn(7, 2), torch.randn(2, 5), 1.0),
    lambda: ops.lora_matmul(torch.randn(3, 8), torch.randn(8, 5),
                            torch.randn(8, 2), torch.randn(3, 5), 1.0),
    lambda: ops.lora_matmul(torch.randn(3, 8), torch.randn(8, 5),
                            torch.randn(8, 0), torch.randn(0, 5), 1.0),
    lambda: ops.lora_matmul(torch.randn(3, 8), torch.randn(8, 5),
                            torch.randn(8, 65), torch.randn(65, 5), 1.0),
    lambda: ops.lora_matmul(torch.randn(3, 8), torch.randn(8, 5),
                            torch.randn(8, 2), torch.randn(2, 5),
                            torch.ones(2)),
    lambda: ops.lora_matmul_dx(torch.randn(3, 4), torch.randn(8, 5),
                               torch.randn(8, 2), torch.randn(2, 5), 1.0),
    lambda: ops.lora_matmul_grad_ab(torch.randn(3, 8), torch.randn(4, 2),
                                    torch.randn(3, 5), torch.randn(3, 2),
                                    1.0),
])
def test_ops_reject_bad_shapes(call):
    with pytest.raises(ValueError):
        call()


def test_kernel_launchers_refuse_cpu_tensors():
    """The launch path checks device, dtype and contiguity before touching
    the library: a CPU tensor raises instead of running anywhere."""
    x, a, b = torch.randn(2, 8), torch.randn(1, 8, 4), torch.randn(1, 4, 3)
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        bgmv_mod.launch(None, x, a, b, idx)
    q = torch.randn(1, 2, 8)
    pool = torch.randn(3, 4, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        paged_mod.launch(None, q, pool, pool,
                         torch.zeros(1, 2, dtype=torch.int32),
                         torch.ones(1, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_mod.launch(None, torch.randn(1, 2, 2, 8),
                         torch.randn(1, 3, 1, 8), torch.randn(1, 3, 1, 8),
                         causal=True, window=None, q_offset=0)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        flash_mod.launch(None, torch.randn(1, 2, 2, 260),
                         torch.randn(1, 3, 1, 260), torch.randn(1, 3, 1, 260),
                         causal=True, window=None, q_offset=0)
    w0, a, b, s = (torch.randn(8, 3), torch.randn(8, 2), torch.randn(2, 3),
                   torch.tensor(1.0))
    with pytest.raises(ValueError, match="CUDA"):
        lora_mod.launch(None, x, w0, a, b, s)
    with pytest.raises(ValueError, match="CUDA"):
        lora_mod.launch_dx(None, torch.randn(2, 3), w0, a, b, s)
    with pytest.raises(ValueError, match="CUDA"):
        lora_mod.launch_grad_ab(None, x, torch.randn(2, 2),
                                torch.randn(2, 3), torch.randn(2, 2), s)


def test_kernel_sources_and_build_recipe():
    names = sorted(p.name for p in _build.sources())
    assert names == ["bgmv.cu", "flash_attn.cu", "lora_matmul.cu",
                     "paged_attn.cu", "recon_agg.cu", "verify.cu"]
    replaced = {"bgmv.cu": "src/repro/kernels/bgmv.py::bgmv",
                "lora_matmul.cu":
                    "src/repro/kernels/lora_matmul.py::lora_matmul",
                "paged_attn.cu":
                    "src/repro/kernels/paged_attn.py::paged_attention",
                "flash_attn.cu":
                    "src/repro/kernels/flash_attn.py::flash_attention",
                "recon_agg.cu":
                    "src/repro/kernels/recon_agg.py::recon_agg",
                "verify.cu":
                    "src/repro/kernels/verify.py::paged_verify_attention"}
    for path in _build.sources():
        head = re.sub(r"\s*\n//\s*", " ", path.read_text().split("#include")[0])
        assert replaced[path.name] in head, path.name
        assert "Bound on the H100" in head, path.name
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    h = _build.source_hash()
    assert h == _build.source_hash() and len(h) == 16
    assert _build.library_path().parent == _build.BUILD_DIR
    assert h in _build.library_path().name
