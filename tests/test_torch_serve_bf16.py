"""bfloat16 serving in the port against the reference's bfloat16 engine, on
the CPU.

Both packages serve the same numpy prompts from the reference's weights and
demo adapters cast to bfloat16 (the reference's own ``astype``, carried into
the port as 16-bit patterns by ``repro_torch.interop``), with a bfloat16
registry and a bfloat16 KV cache, on reduced ``gemma-2b`` and
``minitron-4b``, in both cache modes.

The bound. Both sides compute in bfloat16 but round in different places
(the port's kernels' plain versions keep float32 where the reference's
einsums round, and the summation orders differ). bf16 keeps 8 significant
bits, so a rounding moves a value by at most u = 2^-8 of itself, u/sqrt(3)
rms. A layer rounds 31 values on its way from input to output (two norms;
for each of the 7 projections the base product, the LoRA delta and their
sum; RoPE on q and k; the attention probabilities and output; the GeGLU
activation and gate product; two residual adds) and reads 7 weight
matrices rounded from float32: N = 38 L + 4 with the embedding, the final
norm, the head's weights and product. To first order each error reaches the
final hidden state at its own relative size, independently, so two such
evaluations differ in it by a relative rms of sqrt(2 N) u / sqrt(3), and
each logit by that share of its row's rms; six of those bound every logit
compared. That is ``chip_smoke.bf16_logit_rel(L)`` (0.171 at the reduced
configs' 2 layers, 0.502 at Gemma-2B's 18), the same bound the card's bf16
wave is held to against its float32 wave. The prefill logits (every valid
position of every chunk) and the first decode step's are held to it, per
element against the reference's row rms. A greedy token may differ only
where the port's own top-2 gap, on the path both sides share so far, is
below twice the bound: the first differing token must sit there.

Random weights leave top-2 gaps under twice the bound, so that token rule
ends early; the numeric hold of every decode and verify position is
teacher forcing (``chip_smoke.KeptLogits``): the port's bfloat16 engine
driven along its float32 engine's tokens, each position's logits within
the bound, and the adapters rotated between requests, a wrong engine,
outside it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import AdapterRegistry as JRegistry
from repro.serve import ServeEngine as JEngine
from repro_torch import interop
from repro_torch.serve import AdapterRegistry, ScriptedDrafter, ServeEngine
from test_torch_registry import _chip_smoke
from test_torch_serve import RANKS, Fixture, _np_tree

STEPS = 8
BF16 = torch.bfloat16
BF16_REL = _chip_smoke().bf16_logit_rel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread avoids thread-pool
    overhead and contention with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Bf16Fixture(Fixture):
    """``Fixture``'s weights and adapters cast to bfloat16 on both sides."""

    def __init__(self, name):
        super().__init__(name)
        cast = (lambda x: x.astype(jnp.bfloat16)
                if x.dtype == jnp.float32 else x)
        self.jparams16 = jax.tree.map(cast, self.jparams)
        self.tparams16 = interop.params_from_jax(_np_tree(self.jparams16),
                                                 self.tcfg, device="cpu")
        self.jadapters16 = {aid: jax.tree.map(cast, tr)
                            for aid, tr in self.jadapters.items()}
        self.tadapters16 = {aid: interop.lora_from_jax(_np_tree(tr), "cpu")
                            for aid, tr in self.jadapters16.items()}
        self.rel = BF16_REL(self.tcfg.num_layers)

    def engines16(self, **kw):
        jreg = JRegistry(self.jcfg, capacity=len(RANKS), dtype=jnp.bfloat16)
        treg = AdapterRegistry(self.tcfg, capacity=len(RANKS), dtype=BF16,
                               device="cpu")
        for aid in self.jadapters16:
            jreg.register(aid, self.jadapters16[aid])
            treg.register(aid, self.tadapters16[aid])
        return (JEngine(self.jparams16, self.jcfg, jreg, use_pallas=False,
                        cache_dtype=jnp.bfloat16, **kw),
                ServeEngine(self.tparams16, self.tcfg, treg, device="cpu",
                            cache_dtype=BF16, **kw))

    def hold(self, got, want, what):
        """Per element |got - want| <= rel * rms(want's row)."""
        got = got.float().numpy()
        want = np.asarray(want, np.float32).reshape(got.shape)
        rms = np.sqrt((want ** 2).mean(-1, keepdims=True))
        worst = float((np.abs(got - want) / (self.rel * rms)).max())
        assert np.isfinite(worst) and worst <= 1.0, (what, worst)
        return worst


@pytest.fixture(scope="module", params=("gemma-2b", "minitron-4b"))
def fx(request):
    return Bf16Fixture(request.param)


def test_interop_carries_reference_bf16_leaves_bit_for_bit(fx):
    for leaf, tensor in ((fx.jparams16["embed"], fx.tparams16.embed),
                         (fx.jparams16["layers"]["attn"]["wq"],
                          fx.tparams16.layers["attn"].wq),
                         (fx.jadapters16["client1"]["q"]["B"],
                          fx.tadapters16["client1"]["q"]["B"])):
        assert tensor.dtype == BF16
        np.testing.assert_array_equal(
            tensor.view(torch.int16).numpy(),
            np.asarray(leaf).view(np.int16))


def test_bf16_prefill_and_first_decode_logits(fx):
    """Chunk-by-chunk prefill logits at every valid position, and the first
    batched decode step's logits, from identical engine state on both
    sides, within the bound."""
    jeng, teng = fx.engines16(max_batch=2, max_seq=24, page_size=4,
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
                                torch.as_tensor(idx_np),
                                torch.as_tensor(toks), lo, nv)
        with torch.no_grad():
            tl = teng._logits(x[0, :nv])
        assert tl.dtype == BF16
        fx.hold(tl, np.asarray(jl)[:nv], f"prefill chunk at {lo}")
    first = int(np.argmax(np.asarray(jl, np.float32)[nv - 1]))
    t = prompt.size
    for eng in (jeng, teng):
        eng.kv.extend(0, t // 4 + 1 - eng.kv.allocated(0))
    tables = teng.kv.tables.copy()
    idx = np.zeros((2,), np.int32)
    tokens = np.array([[first], [0]], np.int32)
    pos = np.array([t, 0], np.int32)
    lens = np.array([t + 1, 0], np.int32)
    jl, _ = jeng._step(jeng.params, jeng.registry.slabs(), jeng.kv.pools,
                       *[jnp.asarray(a) for a in (tables, idx, tokens, pos,
                                                  lens)])
    tl = teng._decode_step(*[torch.as_tensor(a) for a in (tables, idx,
                                                          tokens, pos, lens)])
    fx.hold(tl[0], np.asarray(jl)[0], "first decode step")


def _capture_gaps(engine):
    """Record the top-2 gap and rms of every logits row the engine
    computes (one row a call at max_batch 1)."""
    rows = []
    logits = engine._logits

    def wrapped(x):
        z = logits(x)
        top2 = torch.topk(z.float().reshape(-1), 2).values
        rows.append((float(top2[0] - top2[1]),
                     float(z.float().pow(2).mean().sqrt())))
        return z

    engine._logits = wrapped
    return rows


@pytest.mark.parametrize("kv_mode", ["paged", "dense"])
def test_bf16_engine_tokens_hold_to_reference(fx, kv_mode):
    """8 ragged requests, one at a time (max_batch 1, so each logits row is
    one request's), through both bfloat16 engines: the first token that
    differs must sit where the port's own top-2 gap is under twice the
    bound; the counts are equal."""
    kw = dict(max_batch=1, max_seq=24, kv_mode=kv_mode)
    if kv_mode == "paged":
        kw.update(page_size=4, prefill_chunk=4)
    jeng, teng = fx.engines16(**kw)
    rows = _capture_gaps(teng)
    outs = []
    for eng in (jeng, teng):
        uids = [eng.submit(p, f"client{i % len(RANKS)}", max_new_tokens=STEPS)
                for i, p in enumerate(fx.prompts)]
        done = eng.run()
        outs.append([done[u] for u in uids])
    assert (teng.steps, teng.tokens_generated) == (jeng.steps,
                                                   jeng.tokens_generated)
    for i, (j, t) in enumerate(zip(*outs)):
        # the engine's logits rows of request i that sampled a token: its
        # prefill and decode steps, or in dense mode the last STEPS steps
        # of its prompt + STEPS - 1
        calls = STEPS if kv_mode == "paged" else \
            fx.prompts[i].size + STEPS - 1
        mine, rows = rows[:calls], rows[calls:]
        gaps = mine[-STEPS:]
        diff = np.nonzero(t != j)[0]
        if diff.size:
            gap, rms = gaps[int(diff[0])]
            assert gap < 2 * fx.rel * rms, (i, int(diff[0]), gap, rms)
    assert rows == []


@pytest.mark.parametrize("spec", [False, True], ids=["decode", "verify"])
def test_bf16_teacher_forced_positions_hold_and_wrong_adapters_do_not(fx,
                                                                     spec):
    """The card's numeric check of bfloat16 decode and verify, on the CPU:
    ``chip_smoke.KeptLogits`` drives the port's bfloat16 engine along its
    float32 engine's tokens (plain decode, or verify windows under a
    ``ScriptedDrafter`` of those tokens), keeps every sampled position,
    and each is within the bound of the float32 logits there. The control
    the card also runs, the adapters rotated between requests, falls
    outside the bound for every request."""
    cs = _chip_smoke()
    kw = dict(max_batch=4, max_seq=24, page_size=4, prefill_chunk=4)
    names = [f"client{i % len(RANKS)}" for i in range(len(fx.prompts))]
    rotated = [f"client{(i + 1) % len(RANKS)}"
               for i in range(len(fx.prompts))]

    def engine(params, dtype, adapters, drafter=None):
        reg = AdapterRegistry(fx.tcfg, capacity=len(RANKS), dtype=dtype,
                              device="cpu")
        for aid, tree in adapters.items():
            reg.register(aid, tree)
        return ServeEngine(params, fx.tcfg, reg, device="cpu",
                           cache_dtype=dtype,
                           drafter=drafter, **kw)

    def wave(eng, scripts, ids):
        kept = cs.KeptLogits(eng, scripts)
        uids = [eng.submit(p, a, max_new_tokens=STEPS)
                for p, a in zip(fx.prompts, ids)]
        for uid, script in zip(uids, scripts if eng.drafter else ()):
            eng.drafter.set(uid, script)
        kept.bind(uids)
        done = eng.run()
        return [done[u] for u in uids], kept.by_request()

    toks, z32 = wave(engine(fx.tparams, torch.float32, fx.tadapters), None,
                     names)
    assert [len(z) for z in z32] == [STEPS] * len(fx.prompts)
    def engine16():
        return engine(fx.tparams16, BF16, fx.tadapters16,
                      ScriptedDrafter() if spec else None)

    eng = engine16()
    got, z16 = wave(eng, toks, names)
    assert all(np.array_equal(a, b) for a, b in zip(got, toks))
    assert [len(z) for z in z16] == [STEPS] * len(fx.prompts)
    assert all(z.dtype == BF16 for z in z16)
    if spec:
        assert eng.spec_stats()["acceptance_rate"] == 1.0
    worst = cs.bf16_worst(z16, z32, fx.rel)
    assert max(worst) <= 1.0, worst
    _, zc = wave(engine16(), toks, rotated)
    control = cs.bf16_worst(zc, z32, fx.rel)
    assert min(control) > 1.0, control
