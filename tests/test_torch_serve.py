"""The port's serving stack against the reference's, on the CPU.

Allocator, registry and engine are driven through the same scripted
operations on both packages, from the same numpy prompts and the
reference's own weights and demo adapters (carried over by
``repro_torch.interop``). The port's engine runs its kernels' plain
versions here; the reference's runs both its plain path and its Pallas
kernels in interpret mode (``use_pallas=True``). Greedy tokens and
scheduler counts must be equal; logits agree to float32 summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import model as j_model
from repro.serve import AdapterRegistry as JRegistry
from repro.serve import ServeEngine as JEngine
from repro.serve.oracle import make_demo_adapter as j_demo_adapter
from repro.serve.pages import PageAllocator as JAllocator
from repro_torch import interop
from repro_torch.configs import get_reduced
from repro_torch.serve import AdapterRegistry, PageAllocator, ServeEngine
from repro_torch.serve.oracle import merged_greedy

RANKS = (2, 4, 6, 8)
STEPS = 8
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)   # float32, other summation order


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread avoids thread-pool
    overhead and contention with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


class Fixture:
    """One architecture's weights and adapters in both packages."""

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

    def registries(self, capacity=len(RANKS)):
        jreg = JRegistry(self.jcfg, capacity=capacity)
        treg = AdapterRegistry(self.tcfg, capacity=capacity, device="cpu")
        for aid in self.jadapters:
            jreg.register(aid, self.jadapters[aid])
            treg.register(aid, self.tadapters[aid])
        return jreg, treg

    def engines(self, use_pallas=False, **kw):
        jreg, treg = self.registries()
        return (JEngine(self.jparams, self.jcfg, jreg, use_pallas=use_pallas,
                        **kw),
                ServeEngine(self.tparams, self.tcfg, treg, device="cpu", **kw))


@pytest.fixture(scope="module", params=("gemma-2b", "minitron-4b"))
def fx(request):
    return Fixture(request.param)


def _run(engine, prompts, steps, adapters=len(RANKS)):
    uids = [engine.submit(p, f"client{i % adapters}", max_new_tokens=steps)
            for i, p in enumerate(prompts)]
    outs = engine.run()
    return [outs[u] for u in uids]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_engine_tokens_equal_reference_engine(fx, use_pallas):
    """8 ragged requests over 4 heterogeneous-rank adapters, multi-chunk
    prefill and page-boundary crossings: identical greedy tokens."""
    kw = dict(max_batch=8, max_seq=24, page_size=4, prefill_chunk=4)
    jeng, teng = fx.engines(use_pallas=use_pallas, **kw)
    jout = _run(jeng, fx.prompts, STEPS)
    tout = _run(teng, fx.prompts, STEPS)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t, j)
    assert (teng.steps, teng.prefill_calls, teng.tokens_generated) == \
        (jeng.steps, jeng.prefill_calls, jeng.tokens_generated)
    teng.kv.allocator.check()
    assert teng.kv.allocator.free_count == teng.kv.num_pages


def test_engine_matches_port_oracle(fx):
    """The port's own merged-weight oracle gives the engine's tokens."""
    _, teng = fx.engines(max_batch=4, max_seq=24, page_size=4,
                         prefill_chunk=4)
    outs = _run(teng, fx.prompts[:4], STEPS)
    for i, out in enumerate(outs):
        want = merged_greedy(fx.tparams, fx.tcfg, fx.prompts[i],
                             fx.tadapters[f"client{i}"], STEPS)
        np.testing.assert_array_equal(out, want)


def test_prefill_and_first_decode_logits(fx):
    """Chunk-by-chunk prefill logits and the first batched decode step's
    logits, from identical engine state on both sides."""
    jeng, teng = fx.engines(max_batch=2, max_seq=24, page_size=4,
                            prefill_chunk=4)
    prompt = fx.prompts[0]
    need = -(-(prompt.size + 1) // 4)
    for eng in (jeng, teng):
        assert eng.kv.admit(0, need)
        assert eng.registry.acquire("client1") == 0
    idx_np = np.zeros((1,), np.int32)
    for lo in range(0, prompt.size, 4):
        nv = min(4, prompt.size - lo)
        toks = np.zeros((1, 4), np.int32)
        toks[0, :nv] = prompt[lo:lo + nv]
        jl, jeng.kv.pools = jeng._prefill(
            jeng.params, jeng.registry.slabs(), jeng.kv.pools,
            jeng.kv.prefill_tables(0), jnp.asarray(idx_np),
            jnp.asarray(toks), np.int32(lo), np.int32(nv))
        x = teng._prefill_chunk(torch.as_tensor(teng.kv.tables[0:1]),
                                torch.as_tensor(idx_np), torch.as_tensor(toks),
                                lo, nv)
        with torch.no_grad():
            tl = teng._logits(x[0, :nv])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:nv],
                                   **LOGIT_TOL)
    first = int(np.argmax(np.asarray(jl)[nv - 1]))
    # one decode step: row 0 active at position len(prompt), row 1 idle
    t = prompt.size
    for eng in (jeng, teng):
        eng.kv.extend(0, t // 4 + 1 - eng.kv.allocated(0))
    tables = teng.kv.tables.copy()
    np.testing.assert_array_equal(tables, jeng.kv.tables)
    idx = np.zeros((2,), np.int32)
    tokens = np.array([[first], [0]], np.int32)
    pos = np.array([t, 0], np.int32)
    lens = np.array([t + 1, 0], np.int32)
    jl, _ = jeng._step(jeng.params, jeng.registry.slabs(), jeng.kv.pools,
                       *[jnp.asarray(a) for a in (tables, idx, tokens, pos,
                                                  lens)])
    tl = teng._decode_step(*[torch.as_tensor(a) for a in (tables, idx, tokens,
                                                          pos, lens)])
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0], **LOGIT_TOL)


@pytest.mark.parametrize("num_req,prompt_len,steps,ps,num_pages,chunk", [
    (12, 48, 8, 8, 24, 16),   # examples/serve_adapters.py::oversubscribed
    (8, 6, 10, 4, 10, 4),     # tight pool: decode-time preemption
])
def test_oversubscribed_pool_defers_and_preempts_like_reference(
        num_req, prompt_len, steps, ps, num_pages, chunk):
    fx = Fixture("gemma-2b")
    rng = np.random.default_rng(5)
    prompts = rng.integers(3, fx.jcfg.vocab_size, (num_req, prompt_len)
                           ).astype(np.int32)
    kw = dict(max_batch=num_req, max_seq=prompt_len + steps, page_size=ps,
              num_pages=num_pages, prefill_chunk=chunk)
    jeng, teng = fx.engines(**kw)
    jout = _run(jeng, list(prompts), steps)
    tout = _run(teng, list(prompts), steps)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t, j)
    assert teng.deferrals > 0
    assert (teng.deferrals, teng.preemptions) == (jeng.deferrals,
                                                  jeng.preemptions)
    teng.kv.allocator.check()
    assert teng.kv.allocator.free_count == num_pages


def test_page_allocator_scripted_sequence_matches_reference():
    ops = [("alloc", "a", 3), ("alloc", "b", 2), ("alloc", "c", 4),
           ("extend", "a", 2), ("extend", "b", 9), ("pin", "c"),
           ("victims", 6), ("truncate", "a", 2), ("free", "b"),
           ("victims", 4), ("unpin", "c"), ("victims", 9),
           ("alloc", "d", 5), ("extend", "c", 1), ("free", "a"),
           ("truncate", "c", 0), ("alloc", "e", 2), ("victims", 20)]
    ja, ta = JAllocator(10), PageAllocator(10)
    for op, *args in ops:
        assert getattr(ta, op)(*args) == getattr(ja, op)(*args), (op, args)
        assert ta.free_count == ja.free_count
        assert {o: ta.pages_of(o) for o in ta.owners()} == \
            {o: ja.pages_of(o) for o in ja.owners()}
        ta.check()
    for g in ("free", "owners", "pinned"):
        assert ta.metrics.gauge(f"pages.{g}").value == \
            ja.metrics.gauge(f"pages.{g}").value
    for c in ("allocs", "extends", "freed", "truncated"):
        assert ta.metrics.counter(f"pages.{c}").value == \
            ja.metrics.counter(f"pages.{c}").value


def test_registry_slabs_after_register_evict_and_hot_swap(fx):
    jreg, treg = fx.registries(capacity=2)

    def same():
        assert treg.resident() == jreg.resident()
        for t in jreg.slabs():
            for k in ("A", "B", "mask"):
                np.testing.assert_array_equal(
                    treg.slabs()[t][k].numpy(),
                    np.asarray(jreg.slabs()[t][k]))

    for reg in (jreg, treg):
        assert reg.acquire("client0") == 0
        assert reg.acquire("client3") == 1
        reg.release("client0")
        assert reg.acquire("client1") == 0          # evicts client0
        with pytest.raises(RuntimeError):
            reg.acquire("client2")                   # both slots pinned
    same()
    assert (treg.loads, treg.evictions, treg.hits, treg.misses) == \
        (jreg.loads, jreg.evictions, jreg.hits, jreg.misses)
    # hot-swap: mutate the sources in place, then refresh the live slot
    for t in fx.jadapters["client3"]:
        fx.jadapters["client3"][t]["B"] = fx.jadapters["client3"][t]["B"] * 2
        fx.tadapters["client3"][t]["B"].mul_(2)
    try:
        jreg.refresh("client3")
        treg.refresh("client3")
        same()
        assert float(treg.slabs()["q"]["B"][:, 1].abs().sum()) > 0
    finally:
        for t in fx.jadapters["client3"]:
            fx.jadapters["client3"][t]["B"] = \
                fx.jadapters["client3"][t]["B"] / 2
            fx.tadapters["client3"][t]["B"].div_(2)


def test_engine_rejects_unported_modes_and_bad_requests(fx):
    _, treg = fx.registries()
    for kw in ({"kv_mode": "dense"}, {"mesh": object()},
               {"cache_dtype": torch.bfloat16}):
        with pytest.raises(NotImplementedError):
            ServeEngine(fx.tparams, fx.tcfg, treg, device="cpu", **kw)
    eng = ServeEngine(fx.tparams, fx.tcfg, treg, device="cpu", max_seq=8,
                      page_size=4)
    with pytest.raises(ValueError):
        eng.submit(np.arange(3, 9), "client0", max_new_tokens=4)  # > 8
    with pytest.raises(ValueError):
        eng.submit([], "client0", max_new_tokens=2)
    with pytest.raises(KeyError):
        eng.submit([3, 4], "nobody", max_new_tokens=2)
