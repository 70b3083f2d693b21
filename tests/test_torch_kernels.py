"""The port's kernel entry points on the CPU against the reference.

On the CPU ``repro_torch.kernels.ops`` runs each kernel's plain PyTorch
version; here those are held to the reference's jnp oracles
(``repro.kernels.ref``) and to its Pallas kernels in interpret mode
(``repro.kernels.ops``), on the same numpy inputs. The CUDA kernels
themselves run only on the GPU (``chip_smoke.py``); what is checked of
them here is that a CPU tensor never reaches them and that their launch
wrappers refuse what the kernels do not take.
"""
import contextlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.common import _repeat_kv as j_repeat_kv
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import bgmv as bgmv_mod
from repro_torch.kernels import flash_attn as flash_mod
from repro_torch.kernels import lora_matmul as lora_mod
from repro_torch.kernels import paged_attn as paged_mod
from repro_torch.kernels import verify as verify_mod

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


# The page-split plan shared by the paged decode and verify kernels, and the
# decode kernel's split pass in plain PyTorch.

@settings(max_examples=60, deadline=None)
@given(b=st.integers(min_value=1, max_value=16),
       sq=st.integers(min_value=1, max_value=8),
       hkv=st.integers(min_value=1, max_value=8),
       groups=st.integers(min_value=1, max_value=8),
       pages=st.integers(min_value=0, max_value=300),
       sms=st.sampled_from([1, 7, 132, 144]))
def test_page_split_plan_covers_each_page_once(b, sq, hkv, groups, pages,
                                               sms):
    plan = paged_mod.plan_page_splits(b, sq, hkv * groups, hkv, pages, 16,
                                      sms)
    assert plan.n_splits >= 1 and plan.blocks >= 1   # never an empty grid
    assert plan.row_blocks == b * hkv * -(-sq * groups
                                          // paged_mod.ROWS_PER_BLOCK)
    bounds = plan.bounds()
    covered = [p for lo, hi in bounds for p in range(lo, hi)]
    assert covered == list(range(pages))             # once each, in order
    assert all(hi > lo for lo, hi in bounds) or bounds == [(0, 0)]
    assert plan.bounds(16) == [(16 * lo, 16 * hi) for lo, hi in bounds]
    if plan.row_blocks * pages >= sms:               # when the work allows
        assert plan.blocks >= sms
        # and no split that also gives as many blocks costs less
        cost = -(-plan.blocks // sms) * plan.pages_per_split
        for per in range(1, pages + 1):
            blocks = plan.row_blocks * -(-pages // per)
            if blocks >= sms:
                assert -(-blocks // sms) * per >= cost
    else:
        assert plan.pages_per_split == 1


@pytest.mark.parametrize("shape,want", [
    # (B, Sq, H, Hkv, P, page_size) -> (splits, pages a split, blocks)
    ((8, 5, 8, 1, 13, 16), (13, 1, 208)),     # Gemma-2B verify, spec_k 4
    ((8, 1, 8, 1, 13, 16), (13, 1, 104)),     # Gemma-2B decode
    ((8, 5, 8, 1, 128, 16), (16, 8, 256)),    # verify over 2048 positions
    ((8, 1, 8, 1, 128, 16), (32, 4, 256)),    # decode over 2048 positions
    ((8, 5, 24, 8, 13, 16), (13, 1, 832)),    # minitron-4b verify (G 3)
    ((1, 1, 8, 1, 1, 16), (1, 1, 1)),         # one page: no merge
])
def test_page_split_plan_at_the_checked_shapes(shape, want):
    """The plans phase 3 of chip_smoke.py runs on the card's 132 SMs;
    equal costs go to fewer splits (decode over 2048 positions: 1024
    blocks of one page cost as much as 256 of four)."""
    plan = paged_mod.plan_page_splits(*shape, 132)
    assert (plan.n_splits, plan.pages_per_split, plan.blocks) == want


def test_page_split_plan_takes_ints_only():
    """The plan is made on the host from sizes: a device value (a tensor,
    even one element) is refused rather than read."""
    with pytest.raises(TypeError, match="must be an int"):
        paged_mod.plan_page_splits(torch.tensor(8), 1, 8, 1, 13, 16, 132)
    with pytest.raises(TypeError, match="must be an int"):
        paged_mod.plan_page_splits(8, 1, 8, 1, np.int64(13), 16, 132)


def _edge_lengths(ps, pages):
    """Ragged lengths: empty, one position, a page edge, inside a page,
    one past an edge, the whole table."""
    return [0, 1, ps, ps + 3, 2 * ps + 1, pages * ps]


def _split_bounds(pages, ps):
    """Position ranges: the plans at several SM counts, one split of the
    whole table, and uneven runs of whole pages."""
    out = [paged_mod.plan_page_splits(6, 1, 8, 1, pages, ps, sms).bounds(ps)
           for sms in (1, 4, 132)]
    out.append([(0, pages * ps)])
    out.append([(0, ps), (ps, 3 * ps), (3 * ps, pages * ps)])
    return out


@pytest.mark.parametrize("groups", [1, 3, 8])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_partials_merge_to_plain_decode(groups, ps, dtype):
    """The decode kernel's split pass and the merge, in plain PyTorch,
    over any runs of whole pages, give the plain version: float32 within
    1e-5 (sums in another order), bf16 one rounding of the float32 result
    (within one bf16 ulp), length-0 rows exact zeros."""
    pages, hkv, dh = 4, 2, 16
    lengths = _edge_lengths(ps, pages)
    q, kp, vp, tables, lens = _paged_inputs(groups * 10 + ps, len(lengths),
                                            hkv, groups, dh, ps, pages,
                                            lengths)
    q, kp, vp = (_t(a).to(dtype) for a in (q, kp, vp))
    tables, lens = _t(tables), _t(lens)
    want = paged_mod.paged_attention_plain(q, kp, vp, tables, lens)
    for bounds in _split_bounds(pages, ps):
        m, l, o = paged_mod.paged_partials_plain(q, kp, vp, tables, lens,
                                                 bounds)
        assert m.shape == (len(bounds), len(lengths), hkv * groups)
        got = flash_mod.merge_partials_plain(m, l, o, dtype)
        assert got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        else:
            err = (got.float() - want.float()).abs()
            assert bool((err <= 2.0 ** -7 * want.float().abs() + 1e-6).all())
        assert torch.count_nonzero(got[0]) == 0      # length 0
        # a split past the length sees nothing: m = NEG_INF, l = 0, o = 0
        empty = torch.tensor([lo >= int(n) for lo, _ in bounds
                              for n in lens]).reshape(len(bounds), -1)
        assert bool((m[empty] == paged_mod.NEG_INF).all())
        assert torch.count_nonzero(l[empty]) == 0
        assert torch.count_nonzero(o[empty]) == 0


class _RecordingLib:
    """Stands in for the kernel library: records each launcher's
    arguments."""

    def __init__(self):
        self.calls = {}

    def paged_attn_launch(self, *args):
        self.calls["paged_attn_launch"] = args
        return 0

    def paged_verify_launch(self, *args):
        self.calls["paged_verify_launch"] = args
        return 0

    def lora_matmul_launch(self, *args):
        self.calls.setdefault("lora_matmul_launch", []).append(args)
        return 0


def _no_host_read(*_args, **_kw):
    raise AssertionError("the launch path read a tensor on the host")


def test_paged_launch_paths_read_no_tensor_on_the_host(monkeypatch):
    """The paged launchers plan from shapes and pass pointers: with every
    tensor-to-host read made to raise, both still launch, with the plan's
    splits and a scratch of the plan's size. (On a card such a read would
    wait for the device and could not be captured into a CUDA graph.)"""
    monkeypatch.setattr(_build, "check_cuda_args", lambda *a, **k: 0)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    made = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append(a)
                        or empty(*a, **k))
    b, sq, h, hkv, dh, ps, pages = 8, 5, 8, 1, 256, 16, 13
    q = torch.zeros(b, sq, h, dh)
    pool = torch.zeros(b * pages + 1, ps, hkv, dh)
    tables = torch.zeros(b, pages, dtype=torch.int32)
    lens = torch.full((b,), 40, dtype=torch.int32)
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, _no_host_read)
    lib = _RecordingLib()
    verify_mod.launch(lib, q, pool, pool, tables, lens, lens, ps)
    paged_mod.launch(lib, q[:, 0], pool, pool, tables, lens, ps)
    monkeypatch.undo()
    for name, s, want in (("paged_verify_launch", sq, (13, 1)),
                          ("paged_attn_launch", 1, (13, 1))):
        args = lib.calls[name]
        assert all(isinstance(a, (int, float)) or a is None for a in args)
        assert tuple(args[-5:-3]) == want             # splits, pages each
        assert any(shape == (13 * b * s * h * (dh + 2),)
                   for shape in made)                 # the partials


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
    with pytest.raises(ValueError, match="head_dim <= 256"):
        paged_mod.launch(None, torch.randn(1, 2, 260),
                         torch.randn(3, 4, 1, 260), torch.randn(3, 4, 1, 260),
                         torch.zeros(1, 2, dtype=torch.int32),
                         torch.ones(1, dtype=torch.int32), 4)
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


# The tile GEMM of the CUDA lora_matmul forward and dx: its plan (the
# reduction split, from ints), the plain model of its decomposition, and
# the launcher's choice between 16-byte and element loads.

@settings(max_examples=80, deadline=None)
@given(m=st.integers(min_value=1, max_value=700),
       n=st.integers(min_value=1, max_value=2100),
       k=st.integers(min_value=0, max_value=2100),
       sms=st.sampled_from([1, 7, 132, 144]))
def test_lora_split_plan_covers_each_output_and_depth_once(m, n, k, sms):
    plan = lora_mod.plan_splits(m, n, k, sms)
    rows, cols = lora_mod.TILE
    assert plan.tiles_m * plan.tiles_n * plan.n_splits == plan.blocks >= 1
    cells = np.zeros((m, n), dtype=np.int32)
    for i in range(plan.tiles_m):                 # the grid's output tiles
        for j in range(plan.tiles_n):
            assert i * rows < m and j * cols < n  # none empty
            cells[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols] += 1
    assert (cells == 1).all()                     # every output once
    bounds = plan.bounds()
    depth = [d for lo, hi in bounds for d in range(lo, hi)]
    assert depth == list(range(k))                # every depth once, in order
    if k:
        assert all(hi > lo for lo, hi in bounds)
        assert plan.k_per_split % lora_mod.DEPTH == 0
    else:
        assert bounds == [(0, 0)]
    assert 1 <= plan.n_splits <= lora_mod.MAX_SPLITS
    assert plan.tiles_m <= 65535
    # no other split into whole stages, up to four times the fewest that
    # give every SM two blocks, takes fewer waves x depth; none of fewer
    # splits as few
    tiles = plan.tiles_m * plan.tiles_n
    most = 4 * -(-2 * sms // tiles)
    assert plan.n_splits <= max(most, 1)
    cost = lora_mod.plan_cost(plan, sms)
    for splits in range(1, min(-(-k // lora_mod.DEPTH), most) + 1):
        other = lora_mod.split_plan(m, n, k, splits)
        assert lora_mod.plan_cost(other, sms) >= cost
        if other.n_splits < plan.n_splits:
            assert lora_mod.plan_cost(other, sms) > cost


@pytest.mark.parametrize("shape,want", [
    # (m, n, k) -> (splits, depth a split, blocks) on 132 SMs
    ((512, 1024, 1024), (2, 512, 256)),       # RoBERTa-large q/v: fwd, dx
    ((1, 2048, 2048), (8, 256, 256)),         # Gemma-2B oracle, M = 1: q, o
    ((1, 256, 2048), (64, 32, 256)),          # ... k, v
    ((1, 2048, 256), (8, 32, 256)),           # dx of k, v at M = 1
    # phase 3's ragged shape: waves alone would take 63 splits of 16 (31
    # waves, 496 < 512); the cap (4 x 3 splits) keeps 2
    ((500, 1000, 1000), (2, 512, 256)),
    ((37, 1001, 999), (16, 64, 256)),         # the element-load shape
    ((37, 999, 1001), (16, 64, 256)),         # its dx
    ((1, 24, 40), (3, 16, 3)),                # tiny: a block a split
    ((2048, 1024, 1024), (1, 1024, 512)),     # enough tiles: no split
])
def test_lora_split_plan_at_the_checked_shapes(shape, want):
    """The plans phase 3 of chip_smoke.py runs on the card's 132 SMs."""
    plan = lora_mod.plan_splits(*shape, 132)
    assert (plan.n_splits, plan.k_per_split, plan.blocks) == want


def test_lora_split_plan_takes_ints_only():
    """The plan is made on the host from sizes: a device value (a tensor,
    even one element) is refused rather than read."""
    with pytest.raises(TypeError, match="must be an int"):
        lora_mod.plan_splits(torch.tensor(512), 1024, 1024, 132)
    with pytest.raises(TypeError, match="must be an int"):
        lora_mod.plan_splits(512, 1024, np.int64(1024), 132)
    with pytest.raises(TypeError, match="must be an int"):
        lora_mod.plan_splits(512, 1024, 1024, 132.0)


# (m, k, n, r): ragged M, K and N, ranks that are not multiples of 8
@pytest.mark.parametrize("m,k,n,r", [
    (37, 50, 70, 1), (64, 96, 80, 8), (5, 129, 33, 3), (70, 33, 130, 13),
    (1, 200, 24, 29), (20, 48, 16, 5),
])
def test_lora_split_decomposition_equals_the_plain_versions(m, k, n, r):
    """The tile GEMM's arithmetic in plain PyTorch (split partials, the
    low-rank term as R more reduction steps of split 0, the partials
    summed in split order) equals ``lora_matmul_parts`` and
    ``lora_matmul_dx_plain``, for the plan and for forced splits; within
    float32 reordering of O(1) sums (TOL). The forward also equals the
    reference's ``lora_matmul_ref``."""
    x, w0, a, b = (_t(v) for v in _lora_inputs(m * k + r, m, k, n, r))
    dy = torch.from_numpy(np.random.default_rng(r).standard_normal(
        (m, n)).astype(np.float32))
    s = torch.tensor(16.0 / r)
    y_ref, xa_ref = lora_mod.lora_matmul_parts(x, w0, a, b, s)
    dx_ref, g_ref = lora_mod.lora_matmul_dx_plain(dy, w0, a, b, s)
    plans = [(lora_mod.plan_splits(m, n, k, 8),
              lora_mod.plan_splits(m, k, n, 8))]
    plans += [(lora_mod.split_plan(m, n, k, sp),
               lora_mod.split_plan(m, k, n, sp)) for sp in (1, 2, 3, 5)]
    for pf, pd in plans:
        y, xa = lora_mod.lora_matmul_split_plain(x, w0, a, b, s, pf)
        torch.testing.assert_close(y, y_ref, **TOL)
        assert torch.equal(xa, xa_ref)
        dx, g = lora_mod.lora_matmul_dx_split_plain(dy, w0, a, b, s, pd)
        torch.testing.assert_close(dx, dx_ref, **TOL)
        assert torch.equal(g, g_ref)
    np.testing.assert_allclose(y.numpy(), np.asarray(jref.lora_matmul_ref(
        jnp.asarray(x.numpy()), jnp.asarray(w0.numpy()),
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), 16.0 / r)), **TOL)


def test_lora_launcher_picks_element_loads_for_unaligned_operands(
        monkeypatch):
    """16-byte loads need K and N multiples of 16 bytes of elements and
    16-byte aligned operands; otherwise the launcher asks for the kernel
    with element loads. Checked on the host with a stand-in library (no
    card), with the plan's split passed and the partials' scratch sized to
    the plan."""
    assert lora_mod.vector_loads(4, 1024, 1024, (0, 16, 4096))
    assert not lora_mod.vector_loads(4, 1001, 1024, (0,))
    assert not lora_mod.vector_loads(4, 1024, 999, (0,))
    assert not lora_mod.vector_loads(4, 1024, 1024, (0, 4))
    assert not lora_mod.vector_loads(2, 1020, 1024, (0,))   # bf16: 8s
    assert lora_mod.vector_loads(2, 1016, 1024, (0,))
    monkeypatch.setattr(_build, "check_cuda_args", lambda *a, **k: 0)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    made = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append(a)
                        or empty(*a, **k))
    s = torch.tensor(2.0)
    lib = _RecordingLib()

    def aligned(m, k, off=0):
        """(m, k) float32 whose data starts ``off`` elements past a
        16-byte boundary."""
        t = empty(m * k + 8)
        skip = (-t.data_ptr() % 16) // 4 + off
        return t[skip:skip + m * k].view(m, k)

    cases = [  # (x offset, K, N) -> 16-byte loads
        (0, 64, 96, 1),
        (0, 63, 96, 0),          # K not a multiple of 4
        (0, 64, 99, 0),          # N not a multiple of 4
        (1, 64, 96, 0),          # x (and dy) 4 bytes past 16
    ]
    for off, k, n, want in cases:
        w0 = aligned(k, n)
        a, b = torch.zeros(k, 4), torch.zeros(4, n)
        lora_mod.launch(lib, aligned(37, k, off), w0, a, b, s)
        args = lib.calls["lora_matmul_launch"][-1]
        assert all(isinstance(v, int) or v is None for v in args)
        plan = lora_mod.plan_splits(37, n, k, 132)
        assert args[8:14] == (37, n, k, 4, 0, 1)
        assert args[14:17] == (plan.n_splits, plan.k_per_split, want)
        assert (args[7] is None) == (plan.n_splits == 1)
        if plan.n_splits > 1:
            assert (plan.n_splits * 37 * n,) in made
        # dx of the same shapes: dy (37, N) against W0 (K, N)
        lora_mod.launch_dx(lib, aligned(37, n, off), w0, a, b, s)
        args = lib.calls["lora_matmul_launch"][-1]
        plan = lora_mod.plan_splits(37, k, n, 132)
        assert args[8:14] == (37, k, n, 4, 1, 1)
        assert args[14:17] == (plan.n_splits, plan.k_per_split, want)
    # g alone takes no plan and no 16-byte loads
    lora_mod.launch_dx(lib, aligned(37, 96), aligned(64, 96),
                       torch.zeros(64, 4), torch.zeros(4, 96), s,
                       need_dx=False)
    args = lib.calls["lora_matmul_launch"][-1]
    assert args[5] is None and args[7] is None
    assert args[12:17] == (1, 0, 0, 0, 0)
    # a plan made for another shape is refused
    with pytest.raises(ValueError, match="plan for"):
        lora_mod.launch(lib, aligned(37, 64), aligned(64, 96),
                        torch.zeros(64, 4), torch.zeros(4, 96), s,
                        plan=lora_mod.plan_splits(38, 96, 64, 132))
