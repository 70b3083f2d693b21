"""The port's checkpoint-backed adapters (``AdapterRegistry.
register_checkpoint``, ``slot_of``, ``slot_tree``) against the reference's
registry, on the CPU; the counterparts of ``tests/test_checkpoint.py``'s
registry tests.

- Nothing is read before ``acquire``; the checkpoint is read again only to
  re-admit an evicted adapter.
- ``slot_tree`` holds the checkpoint's factors and mask bit for bit in the
  adapter's rank directions and exact zeros past them.
- One scripted acquire/release sequence gives both registries the same
  slots, residents, counts and checkpoint reads.
- Checkpoints cross packages both ways, in float32 and bfloat16.
- Through the serving engine, 8 requests over 4 adapters on a registry of 2
  slots give both packages the same tokens and the counts that
  ``chip_smoke.py`` phase 14 (b) holds the card to (``CKPT_WAVE_COUNTS``).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as j_store
from repro.configs import get_reduced as j_get_reduced
from repro.serve import AdapterRegistry as JRegistry
from repro.serve import ServeEngine as JEngine
from repro.serve.oracle import make_demo_adapter as j_demo_adapter
from repro_torch import interop
from repro_torch.checkpoint import store as t_store
from repro_torch.configs import get_reduced
from repro_torch.serve import AdapterRegistry, ServeEngine
from test_torch_serve import Fixture, _np_tree

ROOT = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread avoids thread-pool
    overhead and contention with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    """``chip_smoke.py`` as a module, for the constants it holds the card
    to (its imports at load time are the standard library's)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trees(cfg, ranks, seed0=0):
    """The reference's demo adapters of ``ranks`` (id -> rank)."""
    return {aid: j_demo_adapter(jax.random.fold_in(KEY, seed0 + i), cfg, r)
            for i, (aid, r) in enumerate(ranks.items())}


def _count_reads(monkeypatch, module):
    """Count ``module.restore`` calls (the registry's only checkpoint read)."""
    reads = []
    restore = module.restore

    def counted(*args, **kw):
        reads.append(args[0])
        return restore(*args, **kw)

    monkeypatch.setattr(module, "restore", counted)
    return reads


def _hold_slot(got, tree, r_slab):
    """``slot_tree``'s leaves hold ``tree``'s in its rank directions, bit
    for bit, and exact zeros past them."""
    for t, ad in tree.items():
        r = np.asarray(ad["A"]).shape[-1]
        a = np.asarray(got[t]["A"])
        b = np.asarray(got[t]["B"])
        m = np.asarray(got[t]["mask"])
        assert a.shape[-1] == b.shape[-2] == m.shape[-1] == r_slab
        np.testing.assert_array_equal(a[..., :r], np.asarray(ad["A"]))
        np.testing.assert_array_equal(b[:, :r, :], np.asarray(ad["B"]))
        np.testing.assert_array_equal(m[..., :r], np.asarray(ad["mask"]))
        assert not a[..., r:].any()
        assert not b[:, r:, :].any()
        assert not m[..., r:].any()


def test_register_checkpoint_is_lazy_and_exact(tmp_path, monkeypatch):
    """fed/ -> checkpoint -> registry, in the port: per-client adapters of
    ranks 2, 5 and 8 saved by the port's store, read on first acquire and
    after an eviction only, each slot exact."""
    cfg = get_reduced("gemma-2b")
    ranks = {"c0": 2, "c1": 5, "c2": 8}
    trees = {aid: interop.lora_from_jax(_np_tree(tr), "cpu")
             for aid, tr in _trees(j_get_reduced("gemma-2b"), ranks).items()}
    reads = _count_reads(monkeypatch, t_store)
    reg = AdapterRegistry(cfg, capacity=2, r_slab=8, device="cpu")
    for aid, tree in trees.items():
        d = str(tmp_path / aid)
        t_store.save(d, 0, tree, meta={"rank": ranks[aid]})
        reg.register_checkpoint(aid, d)
    assert reads == [] and reg.loads == 0 and reg.resident() == []
    assert all(reg.has(aid) for aid in trees)
    for aid in ("c0", "c1"):
        slot = reg.acquire(aid)
        assert reg.slot_of(aid) == slot
        _hold_slot({t: {k: v.numpy() for k, v in leaf.items()}
                    for t, leaf in reg.slot_tree(aid).items()},
                   trees[aid], 8)
        reg.release(aid)
    assert len(reads) == 2
    reg.acquire("c0")                                 # a hit: no read
    reg.release("c0")
    assert len(reads) == 2 and reg.hits == 1
    reg.acquire("c2")                                 # evicts c1, the LRU
    reg.release("c2")
    assert reg.slot_of("c1") is None and reg.evictions == 1
    reg.acquire("c1")                                 # re-admission reads
    assert len(reads) == 4 and reg.loads == 4
    assert reads[-1] == str(tmp_path / "c1")
    _hold_slot({t: {k: v.numpy() for k, v in leaf.items()}
                for t, leaf in reg.slot_tree("c1").items()}, trees["c1"], 8)
    # slot_tree is a copy: a later load into the slot does not change it
    snap = reg.slot_tree("c1")
    reg.release("c1")
    reg.acquire("c2")
    reg.release("c2")
    reg.acquire("c0")                                 # evicts c1's slot
    r = trees["c1"]["q"]["A"].shape[-1]
    assert torch.equal(snap["q"]["A"][..., :r], trees["c1"]["q"]["A"])
    assert not torch.equal(reg.slot_tree("c0")["q"]["A"], snap["q"]["A"])


def test_register_checkpoint_picks_the_step_and_validates(tmp_path):
    cfg = get_reduced("gemma-2b")
    jtrees = _trees(j_get_reduced("gemma-2b"), {"a": 4, "b": 2})
    trees = {k: interop.lora_from_jax(_np_tree(v), "cpu")
             for k, v in jtrees.items()}
    d = str(tmp_path / "ck")
    t_store.save(d, 1, trees["a"])
    t_store.save(d, 2, trees["b"])
    reg = AdapterRegistry(cfg, capacity=2, device="cpu")
    reg.register_checkpoint("latest", d)
    reg.register_checkpoint("first", d, step=1)
    reg.acquire("latest")
    reg.acquire("first")
    for aid, src in (("latest", trees["b"]), ("first", trees["a"])):
        r = src["q"]["B"].shape[1]
        assert torch.equal(reg.slot_tree(aid)["q"]["B"][:, :r],
                           src["q"]["B"])
        assert torch.equal(reg.slot_tree(aid)["q"]["mask"][:, :r],
                           src["q"]["mask"])
    assert not torch.equal(trees["a"]["q"]["mask"], trees["b"]["q"]["mask"])
    bad = str(tmp_path / "bad")
    t_store.save(bad, 0, {"q": trees["a"]["q"]})       # targets missing
    reg = AdapterRegistry(cfg, capacity=2, device="cpu")
    reg.register_checkpoint("bad", bad)               # nothing read yet
    with pytest.raises(ValueError, match="targets"):
        reg.acquire("bad")
    reg.register_checkpoint("none", str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError):
        reg.acquire("none")


SCRIPT = [("acquire", "c0"), ("release", "c0"), ("acquire", "c1"),
          ("acquire", "c0"), ("release", "c1"), ("acquire", "c2"),
          ("acquire", "c3"), ("release", "c0"), ("release", "c2"),
          ("acquire", "c3"), ("acquire", "c1"), ("release", "c3"),
          ("release", "c3"), ("acquire", "c0"), ("release", "c1"),
          ("acquire", "c2"), ("release", "c0"), ("release", "c2"),
          ("acquire", "c1"), ("acquire", "c3")]


def test_eviction_and_reload_counts_equal_reference(tmp_path, monkeypatch):
    """One scripted sequence on a registry of 2 slots over 4 checkpoint
    sources: every acquire's slot (or refusal), the residents, the counts
    and the checkpoint reads equal the reference registry's."""
    jcfg, tcfg = j_get_reduced("gemma-2b"), get_reduced("gemma-2b")
    trees = _trees(jcfg, {"c0": 2, "c1": 4, "c2": 6, "c3": 8}, seed0=10)
    jreads = _count_reads(monkeypatch, j_store)
    treads = _count_reads(monkeypatch, t_store)
    jreg = JRegistry(jcfg, capacity=2)
    treg = AdapterRegistry(tcfg, capacity=2, device="cpu")
    for aid, tree in trees.items():
        d = str(tmp_path / aid)
        j_store.save(d, 0, tree)
        jreg.register_checkpoint(aid, d)
        treg.register_checkpoint(aid, d)
    for op, aid in SCRIPT:
        results = []
        for reg in (jreg, treg):
            try:
                results.append(getattr(reg, op)(aid))
            except RuntimeError as err:
                results.append(("refused", "pinned" in str(err)))
        assert results[0] == results[1], (op, aid, results)
        assert treg.resident() == jreg.resident()
        assert [treg.slot_of(a) for a in trees] == \
            [jreg.slot_of(a) for a in trees]
        assert (treg.loads, treg.evictions, treg.hits, treg.misses) == \
            (jreg.loads, jreg.evictions, jreg.hits, jreg.misses)
        assert treads == jreads
    assert jreg.evictions > 0 and len(jreads) > len(trees)
    for aid in treg.resident():
        jt = jreg.slot_tree(aid)
        for t, leaf in treg.slot_tree(aid).items():
            for k, v in leaf.items():
                np.testing.assert_array_equal(v.numpy(), np.asarray(jt[t][k]))


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_packages_into_either_registry(tmp_path, writer,
                                                         dtype):
    """A checkpoint written by either package loads into both registries:
    the two slots equal each other and the source, bit for bit."""
    jcfg, tcfg = j_get_reduced("gemma-2b"), get_reduced("gemma-2b")
    ranks = {"c0": 3, "c1": 8}
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jtrees = {aid: jax.tree.map(lambda x: x.astype(jdt), tr)
              for aid, tr in _trees(jcfg, ranks, seed0=20).items()}
    jreg = JRegistry(jcfg, capacity=2, dtype=jdt)
    treg = AdapterRegistry(tcfg, capacity=2, dtype=tdt, device="cpu")
    for aid, tree in jtrees.items():
        d = str(tmp_path / aid)
        if writer == "reference":
            j_store.save(d, 0, tree)
        else:
            t_store.save(d, 0, interop.lora_from_jax(_np_tree(tree), "cpu"))
        jreg.register_checkpoint(aid, d)
        treg.register_checkpoint(aid, d)
    for aid, tree in jtrees.items():
        assert jreg.acquire(aid) == treg.acquire(aid)
        jt, tt = jreg.slot_tree(aid), treg.slot_tree(aid)
        for t in tree:
            for k in ("A", "B", "mask"):
                assert tt[t][k].dtype == tdt
                bits = tt[t][k].view(torch.int16) if dtype == "bfloat16" \
                    else tt[t][k]
                want = np.asarray(jt[t][k])
                np.testing.assert_array_equal(
                    bits.numpy(), want.view(np.int16) if dtype == "bfloat16"
                    else want)
        _hold_slot({t: {k: np.asarray(v, np.float32) for k, v in l.items()}
                    for t, l in jt.items()},
                   {t: {k: np.asarray(v, np.float32) for k, v in l.items()}
                    for t, l in tree.items()}, jreg.r_slab)


def test_engine_over_checkpoint_adapters_counts_like_reference(tmp_path):
    """``chip_smoke.py`` phase 14 (b)'s traffic on the CPU: 8 requests of
    32 new tokens round-robin over 4 checkpoint-backed adapters through a
    registry of 2 slots. Both packages give the same tokens, and both
    registries the counts the card is held to."""
    fx = Fixture("gemma-2b")
    jreg = JRegistry(fx.jcfg, capacity=2)
    treg = AdapterRegistry(fx.tcfg, capacity=2, device="cpu")
    for aid, tree in fx.jadapters.items():
        d = str(tmp_path / aid)
        t_store.save(d, 0, fx.tadapters[aid])
        jreg.register_checkpoint(aid, d)
        treg.register_checkpoint(aid, d)
    kw = dict(max_batch=8, max_seq=48, page_size=4, prefill_chunk=4)
    engines = (JEngine(fx.jparams, fx.jcfg, jreg, use_pallas=False, **kw),
               ServeEngine(fx.tparams, fx.tcfg, treg, device="cpu", **kw))
    outs = []
    for eng in engines:
        uids = [eng.submit(p, f"client{i % 4}", max_new_tokens=32)
                for i, p in enumerate(fx.prompts)]
        done = eng.run()
        outs.append([done[u] for u in uids])
    for j, t in zip(*outs):
        np.testing.assert_array_equal(t, j)
    counts = [{k: getattr(reg, k) for k in ("loads", "evictions", "hits",
                                            "misses")}
              for reg in (jreg, treg)]
    assert counts[0] == counts[1] == _chip_smoke().CKPT_WAVE_COUNTS
    assert treg.resident() == jreg.resident() == ["client2", "client3"]
    assert engines[1].steps == engines[0].steps
