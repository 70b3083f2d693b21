"""The port's speculative decode against the reference's, on the CPU.

The verify op's plain version is held to the reference's gather oracle
and to its Pallas kernel in interpret mode; page rollback to the
reference's ``PagedKV``; and the speculative engine, for every drafter,
to the reference's engine (plain and Pallas-interpret) and to the port's
own plain decode. Both packages start from the reference's weights and
adapters (``repro_torch.interop``) and the same numpy prompts. Greedy
tokens and every scheduler and speculation count must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_reduced as j_get_reduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as j_model
from repro.serve import AdapterRegistry as JRegistry
from repro.serve import NGramDrafter as JNGram
from repro.serve import ScriptedDrafter as JScripted
from repro.serve import SelfDrafter as JSelf
from repro.serve import ServeEngine as JEngine
from repro.serve.oracle import make_demo_adapter as j_demo_adapter
from repro.serve.pages import PagedKV as JPagedKV
from repro_torch import interop
from repro_torch.configs import get_reduced
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attn as flash_mod
from repro_torch.kernels import paged_attn as paged_mod
from repro_torch.kernels import verify as verify_mod
from repro_torch.serve import (AdapterRegistry, NGramDrafter, PagedKV,
                               ScriptedDrafter, SelfDrafter, ServeEngine)

RANKS = (2, 4, 6, 8)
STEPS = 10
# float32 on both sides; the products are summed in another order, so
# results agree to a few ulp of O(1) values.
TOL = dict(rtol=1e-5, atol=1e-5)
STATS = ("dispatches", "drafted", "accepted", "rollback_pages")


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


# ---------------------------------------------------------------------------
# the verify op
# ---------------------------------------------------------------------------

def _verify_inputs(seed, bsz, sq, hkv, groups, dh, ps=8, pages=4):
    """Ragged offsets and lengths (the window may end past the length),
    row 0 inactive (length 0)."""
    rng = np.random.default_rng(seed)
    n_pool = bsz * pages
    q = rng.standard_normal((bsz, sq, hkv * groups, dh), dtype=np.float32)
    kp = rng.standard_normal((n_pool + 1, ps, hkv, dh), dtype=np.float32)
    vp = rng.standard_normal((n_pool + 1, ps, hkv, dh), dtype=np.float32)
    tables = rng.permutation(n_pool).reshape(bsz, pages).astype(np.int32)
    offs = rng.integers(0, pages * ps - sq + 1, bsz).astype(np.int32)
    lens = (offs + rng.integers(1, sq + 1, bsz)).astype(np.int32)
    lens[0] = 0
    return q, kp, vp, tables, lens, offs


@pytest.mark.parametrize("sq,hkv,groups,dh,seed", [
    (1, 1, 1, 16, 0),
    (1, 2, 4, 32, 1),
    (2, 2, 4, 32, 2),
    (2, 1, 1, 100, 3),
    (5, 1, 4, 100, 4),      # MQA, unaligned head dim
    (5, 2, 1, 16, 5),
])
def test_verify_plain_matches_reference_oracle_and_pallas(sq, hkv, groups,
                                                          dh, seed):
    args = _verify_inputs(seed, 3, sq, hkv, groups, dh)
    want = np.asarray(jref.paged_verify_ref(*map(jnp.asarray, args)))
    pallas = np.asarray(jops.paged_verify_attention(
        *map(jnp.asarray, args), page_size=8, interpret=True))
    plain = verify_mod.paged_verify_attention_plain(*map(_t, args)).numpy()
    got = ops.paged_verify_attention(*map(_t, args), page_size=8).numpy()
    np.testing.assert_array_equal(got, plain)   # CPU tensors: plain version
    np.testing.assert_allclose(plain, want, **TOL)
    np.testing.assert_allclose(plain, pallas, **TOL)
    assert not plain[0].any()                    # inactive row: exact zeros


def test_verify_sq1_equals_decode_attention():
    """One token per row at q_offsets = lengths - 1 is decode attention."""
    q, kp, vp, tables, lens, _ = _verify_inputs(7, 4, 1, 2, 4, 32)
    offs = np.maximum(lens - 1, 0)
    ver = verify_mod.paged_verify_attention_plain(
        *map(_t, (q, kp, vp, tables, lens, offs)))[:, 0]
    dec = paged_mod.paged_attention_plain(*map(_t, (q[:, 0], kp, vp, tables,
                                                    lens)))
    torch.testing.assert_close(ver, dec, rtol=1e-6, atol=1e-6)


def test_verify_is_causal_inside_the_window():
    """K/V at position q_offsets + j moves no output token i < j, and
    moves every token i >= j."""
    sq, ps = 4, 8
    q, kp, vp, tables, lens, offs = _verify_inputs(11, 2, sq, 2, 1, 32, ps)
    lens = offs + sq                                  # both rows active
    base = verify_mod.paged_verify_attention_plain(
        *map(_t, (q, kp, vp, tables, lens, offs))).numpy()
    b, j = 1, 2
    pos = int(offs[b]) + j
    kp2, vp2 = kp.copy(), vp.copy()
    page = int(tables[b, pos // ps])
    kp2[page, pos % ps] = 9.0
    vp2[page, pos % ps] = 9.0
    got = verify_mod.paged_verify_attention_plain(
        *map(_t, (q, kp2, vp2, tables, lens, offs))).numpy()
    np.testing.assert_array_equal(got[b, :j], base[b, :j])
    assert all(not np.allclose(got[b, i], base[b, i]) for i in range(j, sq))
    np.testing.assert_array_equal(got[0], base[0])


def test_verify_on_cpu_tensors_runs_the_plain_version_without_building(
        monkeypatch):
    def no_build():
        raise AssertionError("a CPU call must not build or load kernels")

    monkeypatch.setattr(_build, "load", no_build)
    before = dict(ops.LAUNCHES)
    args = list(map(_t, _verify_inputs(0, 2, 3, 1, 2, 8)))
    torch.testing.assert_close(
        ops.paged_verify_attention(*args, page_size=8),
        verify_mod.paged_verify_attention_plain(*args))
    assert ops.LAUNCHES == before
    assert "paged_verify_attention" in ops.LAUNCHES


def test_verify_op_and_launcher_refuse_what_the_kernel_does_not_take():
    q, kp, vp, tables, lens, offs = map(_t, _verify_inputs(0, 2, 3, 1, 2,
                                                           8))
    with pytest.raises(ValueError):                   # q without Sq axis
        ops.paged_verify_attention(q[:, 0], kp, vp, tables, lens, offs,
                                   page_size=8)
    with pytest.raises(ValueError):                   # offsets of 3 rows
        ops.paged_verify_attention(q, kp, vp, tables, lens,
                                   torch.zeros(3, dtype=torch.int32),
                                   page_size=8)
    with pytest.raises(ValueError, match="CUDA"):
        verify_mod.launch(None, q, kp, vp, tables, lens, offs, 8)
    # A block's shared memory no longer grows with Sq*G: the shape the
    # one-block-per-row kernel refused (Sq 64, G 8, Dh 256) passes the
    # shape checks and is stopped only by the device check here.
    big = torch.zeros(1, 64, 8, 256)
    pool = torch.zeros(3, 16, 1, 256)
    one = torch.ones(1, dtype=torch.int32)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        verify_mod.launch(None, big, pool, pool, tables, one, one, 16)
    # What it refuses: Dh past the split kernel's register tiles, a clear
    # error before anything is launched, no fallback.
    wide = torch.zeros(1, 5, 8, 260)
    wpool = torch.zeros(3, 16, 1, 260)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        verify_mod.launch(None, wide, wpool, wpool, tables, one, one, 16)


def _frontier_inputs(seed, sq, hkv, groups, dh, ps, pages, dtype):
    """Rows whose causal frontier min(length, offset + Sq) falls: nowhere
    (length 0), inside a page, at a page edge, one past an edge, and past
    the length (the window runs on beyond it), plus the whole table."""
    rng = np.random.default_rng(seed)
    offs = np.array([0, ps + 2, 2 * ps - sq, 2 * ps - sq + 1, ps - 1,
                     pages * ps - sq], np.int32).clip(0)
    lens = np.minimum(offs + sq, pages * ps).astype(np.int32)
    lens[0] = 0
    lens[4] = offs[4] + 1                     # only the first token is valid
    bsz = len(offs)
    n_pool = bsz * pages
    q = rng.standard_normal((bsz, sq, hkv * groups, dh), dtype=np.float32)
    kp = rng.standard_normal((n_pool + 1, ps, hkv, dh), dtype=np.float32)
    vp = rng.standard_normal((n_pool + 1, ps, hkv, dh), dtype=np.float32)
    tables = rng.permutation(n_pool).reshape(bsz, pages).astype(np.int32)
    return (_t(q).to(dtype), _t(kp).to(dtype), _t(vp).to(dtype), _t(tables),
            _t(lens), _t(offs))


@settings(max_examples=24, deadline=None)
@given(sq=st.integers(min_value=1, max_value=5),
       groups=st.sampled_from([1, 3, 8]),
       ps=st.sampled_from([8, 16]),
       hkv=st.sampled_from([1, 2]),
       sms=st.sampled_from([1, 4, 132]),
       bf16=st.booleans(),
       seed=st.integers(min_value=0, max_value=2 ** 16))
def test_verify_split_partials_merge_to_the_plain_version(sq, groups, ps, hkv,
                                                          sms, bf16, seed):
    """The verify kernel's split pass over the plan's runs of pages, then
    the merge, in plain PyTorch, give the plain version: float32 within
    1e-5 (sums in another order), bf16 one rounding of the float32 result
    (one bf16 ulp); a length-0 row gives exact zeros."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    pages = 4
    args = _frontier_inputs(seed, sq, hkv, groups, 16, ps, pages, dtype)
    plan = paged_mod.plan_page_splits(args[0].shape[0], sq, hkv * groups,
                                      hkv, pages, ps, sms)
    m, l, o = verify_mod.paged_partials_plain(*args, plan.bounds(ps))
    assert o.shape == (plan.n_splits, *args[0].shape)
    got = flash_mod.merge_partials_plain(m, l, o, dtype)
    want = verify_mod.paged_verify_attention_plain(*args)
    assert got.dtype == want.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        err = (got.float() - want.float()).abs()
        assert bool((err <= 2.0 ** -7 * want.float().abs() + 1e-6).all())
    assert torch.count_nonzero(got[0]) == 0


@pytest.mark.parametrize("bounds", [
    [(0, 32)],                                 # one split, no merge
    [(0, 8), (8, 16), (16, 24), (24, 32)],     # one page each
    [(0, 8), (8, 32)],                         # uneven runs
])
def test_verify_split_partials_of_a_frontier_inside_the_split(bounds):
    """A split wholly past a row's frontier is empty (m = NEG_INF, l = 0,
    o = 0); a token sees exactly the positions up to its own, so the
    partials move with K/V at a visible position and not with one past
    the token (pages of 8, Sq 3)."""
    q, kp, vp, tables, lens, offs = _frontier_inputs(3, 3, 1, 3, 8, 8, 4,
                                                     torch.float32)
    m, l, o = verify_mod.paged_partials_plain(q, kp, vp, tables, lens, offs,
                                              bounds)
    front = torch.minimum(lens, offs + 3)
    for s, (lo, _) in enumerate(bounds):
        past = front <= lo
        assert bool((m[s][past] == paged_mod.NEG_INF).all())
        assert torch.count_nonzero(l[s][past]) == 0
        assert torch.count_nonzero(o[s][past]) == 0
    b, i = 2, 0                               # token 0 of row 2
    pos = int(offs[b]) + 1                    # past it, inside the frontier
    kp2 = kp.clone()
    kp2[int(tables[b, pos // 8]), pos % 8] = 50.0
    m2, l2, o2 = verify_mod.paged_partials_plain(q, kp2, vp, tables, lens,
                                                 offs, bounds)
    assert torch.equal(o2[:, b, i], o[:, b, i])
    assert not torch.equal(o2[:, b, i + 1], o[:, b, i + 1])


@pytest.mark.parametrize("groups,ps,sms", [(1, 8, 132), (3, 16, 4),
                                           (8, 8, 1), (8, 16, 132)])
def test_verify_split_partials_at_sq1_equal_decode_partials(groups, ps, sms):
    """One token per row at q_offsets = lengths - 1 is decode: the verify
    and decode split passes agree split by split over the same plan (the
    kernels share one body and give the same bits there)."""
    pages, hkv = 4, 2
    rng = np.random.default_rng(groups * 100 + ps)
    lens = np.array([0, 1, ps, ps + 3, 2 * ps + 1, pages * ps], np.int32)
    bsz, n_pool = len(lens), len(lens) * pages
    q = _t(rng.standard_normal((bsz, hkv * groups, 16), dtype=np.float32))
    kp, vp = (_t(rng.standard_normal((n_pool + 1, ps, hkv, 16),
                                     dtype=np.float32)) for _ in range(2))
    tables = _t(rng.permutation(n_pool).reshape(bsz, pages).astype(np.int32))
    lens = _t(lens)
    offs = torch.clamp(lens - 1, min=0).to(torch.int32)
    plan = paged_mod.plan_page_splits(bsz, 1, hkv * groups, hkv, pages, ps,
                                      sms)
    assert plan == paged_mod.plan_page_splits(bsz, 1, hkv * groups, hkv,
                                              pages, ps, sms)
    ver = verify_mod.paged_partials_plain(q[:, None], kp, vp, tables, lens,
                                          offs, plan.bounds(ps))
    dec = paged_mod.paged_partials_plain(q, kp, vp, tables, lens,
                                         plan.bounds(ps))
    for v, d in zip(ver, dec):
        torch.testing.assert_close(v[:, :, 0], d, rtol=0, atol=1e-6)
    torch.testing.assert_close(
        flash_mod.merge_partials_plain(*ver, torch.float32)[:, 0],
        paged_mod.paged_attention_plain(q, kp, vp, tables, lens), rtol=0,
        atol=1e-6)


# ---------------------------------------------------------------------------
# page rollback
# ---------------------------------------------------------------------------

def test_paged_kv_truncate_matches_reference():
    ops_ = [("admit", 0, 2), ("admit", 1, 3), ("extend", 0, 2),
            ("truncate", 0, 5), ("truncate", 1, 0), ("admit", 2, 1),
            ("extend", 2, 3), ("truncate", 2, 9), ("release", 1),
            ("truncate", 0, 100), ("extend", 0, 2), ("truncate", 0, 4),
            ("admit", 1, 4), ("truncate", 1, 15), ("truncate", 2, 3),
            ("release", 0), ("extend", 2, 1), ("truncate", 2, 8)]
    jkv = JPagedKV(1, 12, 4, 6, 3, 1, 8)
    tkv = PagedKV(1, 12, 4, 6, 3, 1, 8, device="cpu")
    for op, *args in ops_:
        assert getattr(tkv, op)(*args) == getattr(jkv, op)(*args), (op, args)
        np.testing.assert_array_equal(tkv.tables, jkv.tables)
        assert tkv.allocator.free_count == jkv.allocator.free_count
        assert [tkv.allocated(r) for r in range(3)] == \
            [jkv.allocated(r) for r in range(3)]
        tkv.allocator.check()
    with pytest.raises(ValueError):
        tkv.truncate(2, -1)
    for c in ("allocs", "extends", "freed", "truncated"):
        assert tkv.metrics.counter(f"pages.{c}").value == \
            jkv.metrics.counter(f"pages.shard0.{c}").value


# ---------------------------------------------------------------------------
# the speculative engine
# ---------------------------------------------------------------------------

def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


class Fixture:
    """One architecture's weights and adapters in both packages, and the
    port's plain-decode tokens for the standard traffic."""

    def __init__(self, name):
        self.jcfg, self.tcfg = j_get_reduced(name), get_reduced(name)
        key = jax.random.PRNGKey(0)
        self.jparams = j_model.init_params(key, self.jcfg)
        self.tparams = interop.params_from_jax(_np_tree(self.jparams),
                                               self.tcfg, device="cpu")
        self.jadapters = {
            f"client{i}": j_demo_adapter(jax.random.fold_in(key, 100 + i),
                                         self.jcfg, r)
            for i, r in enumerate(RANKS)}
        self.tadapters = {aid: interop.lora_from_jax(_np_tree(tr), "cpu")
                          for aid, tr in self.jadapters.items()}
        rng = np.random.default_rng(3)
        lens = rng.integers(3, 13, 8)
        self.prompts = [rng.integers(3, self.jcfg.vocab_size, n)
                        .astype(np.int32) for n in lens]
        self.kw = dict(max_batch=8, max_seq=int(lens.max()) + STEPS,
                       page_size=4)
        plain = self.port_engine(prefill_chunk=4)
        self.plain = _run(plain, self.prompts)

    def registries(self):
        jreg = JRegistry(self.jcfg, capacity=len(RANKS))
        treg = AdapterRegistry(self.tcfg, capacity=len(RANKS), device="cpu")
        for aid in self.jadapters:
            jreg.register(aid, self.jadapters[aid])
            treg.register(aid, self.tadapters[aid])
        return jreg, treg

    def port_engine(self, **kw):
        return ServeEngine(self.tparams, self.tcfg, self.registries()[1],
                           device="cpu", **{**self.kw, **kw})

    def engines(self, jdrafter, tdrafter, use_pallas=False, **kw):
        jreg, treg = self.registries()
        kw = {**self.kw, **kw}
        return (JEngine(self.jparams, self.jcfg, jreg, use_pallas=use_pallas,
                        drafter=jdrafter, **kw),
                ServeEngine(self.tparams, self.tcfg, treg, device="cpu",
                            drafter=tdrafter, **kw))


_FIXTURES = {}


def _fixture(name):
    if name not in _FIXTURES:
        _FIXTURES[name] = Fixture(name)
    return _FIXTURES[name]


@pytest.fixture(scope="module", params=("gemma-2b", "minitron-4b"))
def fx(request):
    return _fixture(request.param)


def _run(engine, prompts, scripts=None):
    uids = [engine.submit(p, f"client{i % len(RANKS)}", max_new_tokens=STEPS)
            for i, p in enumerate(prompts)]
    if scripts is not None:
        for uid, s in zip(uids, scripts):
            engine.drafter.set(uid, s)
    outs = engine.run()
    return [outs[u] for u in uids]


def _drafters(kind):
    """The same drafter in both packages."""
    if kind in ("accept", "reject"):
        return JScripted(), ScriptedDrafter()
    if kind == "self1":
        return JSelf(1), SelfDrafter(1)
    return JNGram(2), NGramDrafter(2)


def _scripts(kind, plain, vocab):
    if kind == "accept":
        return plain
    if kind == "reject":
        return [(p + 1) % vocab for p in plain]
    return None


def _assert_same_run(jeng, teng, jout, tout, want):
    for j, t, w in zip(jout, tout, want):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, w)
    assert {k: teng.spec_stats()[k] for k in STATS} == \
        {k: jeng.spec_stats()[k] for k in STATS}
    assert (teng.steps, teng.prefill_calls, teng.tokens_generated,
            teng.deferrals, teng.preemptions) == \
        (jeng.steps, jeng.prefill_calls, jeng.tokens_generated,
         jeng.deferrals, jeng.preemptions)
    teng.kv.allocator.check()
    assert teng.kv.allocator.free_count == teng.kv.num_pages


@pytest.mark.parametrize("kind,spec_k,chunk", [
    ("accept", 4, 4), ("reject", 4, 4), ("self1", 4, 4), ("ngram2", 4, 4),
    ("accept", 1, 8), ("self1", 1, 8),
])
def test_spec_engine_equals_reference_and_plain_decode(fx, kind, spec_k,
                                                       chunk):
    """Identical tokens (equal to the port's plain decode), speculation
    counts and scheduler counts for every drafter, spec_k and chunk size."""
    jd, td = _drafters(kind)
    jeng, teng = fx.engines(jd, td, spec_k=spec_k, prefill_chunk=chunk)
    scripts = _scripts(kind, fx.plain, fx.jcfg.vocab_size)
    jout = _run(jeng, fx.prompts, scripts)
    tout = _run(teng, fx.prompts, scripts)
    _assert_same_run(jeng, teng, jout, tout, fx.plain)
    stats = teng.spec_stats()
    if kind == "accept":
        assert stats["accepted"] == stats["drafted"] > 0
        assert teng.spec_dispatches < STEPS - 1
    if kind == "reject":
        assert stats["accepted"] == 0 and stats["rollback_pages"] > 0
        assert teng.spec_dispatches == STEPS - 1


@pytest.mark.parametrize("kind", ["accept", "self1"])
def test_spec_engine_under_page_pressure_like_reference(kind):
    """A pool far smaller than the traffic: admission defers, extension
    preempts, windows roll back, and every count equals the reference's."""
    fx = _fixture("gemma-2b")
    rng = np.random.default_rng(5)
    prompts = list(rng.integers(3, fx.jcfg.vocab_size, (8, 6))
                   .astype(np.int32))
    kw = dict(max_batch=8, max_seq=6 + STEPS, page_size=4, num_pages=10,
              prefill_chunk=4)
    plain = _run(fx.port_engine(**kw), prompts)
    jd, td = _drafters(kind)
    jeng, teng = fx.engines(jd, td, spec_k=4, **kw)
    scripts = _scripts(kind, plain, fx.jcfg.vocab_size)
    jout = _run(jeng, prompts, scripts)
    tout = _run(teng, prompts, scripts)
    _assert_same_run(jeng, teng, jout, tout, plain)
    assert teng.deferrals > 0 and teng.preemptions > 0


def test_spec_engine_equals_reference_pallas_interpret(fx):
    """The reference's TPU path (BGMV, verify and flash kernels in interpret
    mode) on two requests, forced-accept."""
    jd, td = _drafters("accept")
    jeng, teng = fx.engines(jd, td, use_pallas=True, spec_k=4,
                            prefill_chunk=4)
    jout = _run(jeng, fx.prompts[:2], fx.plain[:2])
    tout = _run(teng, fx.prompts[:2], fx.plain[:2])
    _assert_same_run(jeng, teng, jout, tout, fx.plain[:2])


def test_spec_constructor_and_drafter_errors(fx):
    _, treg = fx.registries()
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(fx.tparams, fx.tcfg, treg, device="cpu",
                    drafter=NGramDrafter(), spec_k=0)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(fx.tparams, fx.tcfg, treg, device="cpu",
                    kv_mode="dense", drafter=NGramDrafter())
    with pytest.raises(ValueError):
        SelfDrafter(0)
    with pytest.raises(ValueError):
        NGramDrafter(0)
    deep = fx.port_engine(drafter=SelfDrafter(fx.tcfg.num_layers + 1))
    deep.submit(fx.prompts[0], "client0", max_new_tokens=4)
    with pytest.raises(ValueError, match="depth"):
        deep.run()
    drafter = SelfDrafter(1)
    for _ in range(2):
        eng = fx.port_engine(drafter=drafter)
        eng.submit(fx.prompts[0], "client0", max_new_tokens=4)
        if drafter._engine is None:
            eng.run()
        else:
            with pytest.raises(RuntimeError, match="another engine"):
                eng.run()

    class Short:
        def propose(self, engine, active):
            return np.zeros((len(active), engine.spec_k - 1), np.int32)

    eng = fx.port_engine(drafter=Short())
    eng.submit(fx.prompts[0], "client0", max_new_tokens=4)
    with pytest.raises(ValueError, match="proposed"):
        eng.run()
