"""The port's dense ring cache (``ServeEngine(kv_mode="dense")``) against
the reference's, on the CPU.

Both packages serve the same numpy prompts from the reference's weights
and demo adapters (carried over by ``repro_torch.interop``) on reduced
``gemma-2b`` and ``minitron-4b``; the reference runs its plain path and its
Pallas kernels in interpret mode (``use_pallas=True``), the port its
kernels' plain versions. The dense path rounds nothing differently from
the paged one, so the greedy tokens, the scheduler's counts, the cache's
bytes and row capacity must be equal, and the ring's ``pos`` bit for bit
(its K/V to float32 summation order). Also ported: the ring overrun's
``RuntimeError``, the insert that drops an out-of-range write leaving the
cache bit-identical, the ``ValueError`` for a drafter on the dense cache,
and the recorded events of a dense run.
"""
import numpy as np
import pytest
import torch

import repro.obs as J
import repro_torch.obs as T
from repro.serve import ServeEngine as JEngine
from repro_torch.serve import NGramDrafter, ServeEngine
from repro_torch.serve.engine import _cache_insert_rows
from repro_torch.serve.oracle import merged_greedy
from test_torch_obs import SLO, _counters, _hold_time_args, _shape
from test_torch_serve import RANKS, Fixture, _run

STEPS = 8
KV_TOL = dict(rtol=1e-5, atol=1e-5)      # float32, other summation order


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread avoids thread-pool
    overhead and contention with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=("gemma-2b", "minitron-4b"))
def fx(request):
    return Fixture(request.param)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_dense_engine_equals_reference_dense_engine(fx, use_pallas):
    """8 ragged requests over 4 heterogeneous-rank adapters, every prompt
    fed one token a step: identical tokens and counts, the same cache."""
    kw = dict(max_batch=8, max_seq=24, kv_mode="dense")
    jeng, teng = fx.engines(use_pallas=use_pallas, **kw)
    jout = _run(jeng, fx.prompts, STEPS)
    tout = _run(teng, fx.prompts, STEPS)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t, j)
    assert (teng.steps, teng.tokens_generated, teng.prefill_calls,
            teng.deferrals, teng.preemptions, teng.bgmv_groups) == \
        (jeng.steps, jeng.tokens_generated, jeng.prefill_calls,
         jeng.deferrals, jeng.preemptions, jeng.bgmv_groups)
    assert teng.steps == max(p.size for p in fx.prompts) + STEPS - 1
    assert teng.kv_cache_bytes() == jeng.kv_cache_bytes()
    assert teng.row_capacity() == jeng.row_capacity() == 24
    np.testing.assert_array_equal(teng.kv.pools["pos"].numpy(),
                                  np.asarray(jeng.cache["pos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(teng.kv.pools[name].numpy(),
                                   np.asarray(jeng.cache[name]), **KV_TOL)


def test_dense_engine_matches_port_oracle_and_paged_engine(fx):
    """Row recycling across waves: a second wave on the same engine reuses
    rows whose ring was reset, and every request's tokens equal the
    merged-weight oracle's and the paged engine's."""
    _, teng = fx.engines(max_batch=3, max_seq=24, kv_mode="dense")
    _, paged = fx.engines(max_batch=3, max_seq=24, page_size=4,
                          prefill_chunk=4)
    for wave in (fx.prompts[:4], fx.prompts[4:]):
        dense_out = _run(teng, wave, STEPS)
        assert teng.kv.pools["pos"].max() < 24
        for i, (out, want) in enumerate(zip(dense_out,
                                            _run(paged, wave, STEPS))):
            np.testing.assert_array_equal(out, want)
            np.testing.assert_array_equal(out, merged_greedy(
                fx.tparams, fx.tcfg, wave[i], fx.tadapters[f"client{i}"],
                STEPS))
    assert teng.registry.resident() == [f"client{i}" for i in range(4)]


def test_dense_ring_overflow_raises_not_corrupts(fx):
    """A row driven past its ring fails loudly, in both packages, rather
    than wrapping onto its oldest live slots (tests/test_serve.py)."""
    jeng, teng = fx.engines(max_batch=1, max_seq=8, kv_mode="dense")
    for eng in (jeng, teng):
        eng.submit(fx.prompts[0][:4], "client0", max_new_tokens=4)
        # bypass submit's guard, as a scheduler bug might
        eng._queue[0]["max_new"] = 10
        with pytest.raises(RuntimeError, match="ring"):
            eng.run()
    assert teng.steps == jeng.steps == 8
    np.testing.assert_array_equal(teng.kv.pools["pos"].numpy(),
                                  np.asarray(jeng.cache["pos"]))


def test_dense_insert_drops_out_of_range_writes():
    """An out-of-range position leaves the cache bit-identical instead of
    wrapping onto slot 0 or clipping onto the last slot; the rows inside
    the ring are still written (tests/test_serve.py)."""
    lc = {"k": torch.ones((2, 4, 1, 8)), "v": torch.ones((2, 4, 1, 8)),
          "pos": torch.zeros((2, 4), dtype=torch.int32)}
    before = {n: t.clone() for n, t in lc.items()}
    k_new = torch.full((2, 1, 1, 8), 7.0)
    out = _cache_insert_rows(lc, k_new, k_new,
                             torch.tensor([5, 9], dtype=torch.int32))
    for n in lc:
        assert torch.equal(out[n], before[n]), n
    out = _cache_insert_rows(lc, k_new, k_new,
                             torch.tensor([4, 3], dtype=torch.int32))
    assert torch.equal(out["k"][0], before["k"][0])
    assert torch.equal(out["k"][1, :3], before["k"][1, :3])
    assert torch.equal(out["k"][1, 3], k_new[1, 0])
    assert out["pos"].tolist() == [[0, 0, 0, 0], [0, 0, 0, 3]]


def test_drafter_requires_paged_mode(fx):
    """The reference's ValueError (tests/test_spec.py): rollback is a
    page-table operation, and the dense cache has no verify path."""
    _, treg = fx.registries()
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(fx.tparams, fx.tcfg, treg, device="cpu",
                    kv_mode="dense", drafter=NGramDrafter())
    with pytest.raises(ValueError, match="kv_mode"):
        ServeEngine(fx.tparams, fx.tcfg, treg, device="cpu",
                    kv_mode="ring")


def test_recorded_dense_engine_matches_reference():
    """A recorded dense run records what the reference's does: the same
    (phase, name, track, args) sequence, a decode_step span a step (no
    prefill chunks), the same counters and histogram counts."""
    fx = Fixture("gemma-2b")
    jrec, trec = J.Recorder(), T.Recorder()
    jreg, treg = fx.registries()
    kw = dict(max_batch=4, max_seq=24, kv_mode="dense", slo_ttft_s=SLO)
    jeng = JEngine(fx.jparams, fx.jcfg, jreg, use_pallas=False,
                   recorder=jrec, **kw)
    teng = ServeEngine(fx.tparams, fx.tcfg, treg, device="cpu",
                       recorder=trec, **kw)
    outs = []
    for eng in (jeng, teng):
        uids = [eng.submit(p, f"client{i % len(RANKS)}",
                           max_new_tokens=STEPS,
                           slo_class=("tight", "loose")[i % 2])
                for i, p in enumerate(fx.prompts)]
        done = eng.run()
        outs.append([done[u] for u in uids])
    for j, t in zip(*outs):
        np.testing.assert_array_equal(t, j)
    tev, jev = trec.events(), jrec.events()
    assert _shape(tev) == _shape(jev)
    names = [e[1] for e in tev]
    assert names.count("decode_step") == teng.steps
    assert "prefill_chunk" not in names and "defer" not in names
    _hold_time_args(tev, teng)
    _hold_time_args(jev, jeng)
    assert _counters(teng.metrics, False) == _counters(jeng.metrics, True)
    for h in ("serve.ttft_s", "serve.request_s", "serve.decode_step_s"):
        assert teng.metrics.histogram(h).count == \
            jeng.metrics.histogram(h).count > 0, h
    assert teng.slo_attainment() == jeng.slo_attainment()
    T.validate_chrome_trace(T.chrome_trace(tev))
