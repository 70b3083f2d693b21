"""The port's observability layer against the reference's, on the CPU.

The same events, made from a seed with numpy, go through both packages'
exporters, time series, SLO monitor, report and collection: the results
must be equal (Chrome-trace dicts, JSONL bytes, each package reading the
other's files, ``as_dict`` snapshots, rendered text, rebased and merged
streams). ``collect`` runs in a real child process that imports only
``repro_torch.obs``.

The recorded engine and the recorded round run both packages from the
reference's weights (``repro_torch.interop``) and must record the same
``(phase, name, track)`` sequence with the same args. Time-valued args
(``TIME_KEYS``) are host times of two different implementations and are
not compared across packages: each side's must be finite and positive and
agree with its own histograms. Counters, SLO totals and the tokens must be
equal, the tokens also to the port's unrecorded run.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.obs as J
from repro.analysis import run_paths
from repro.configs import get_reduced as j_get_reduced
from repro.core import agg_engine as j_engine
from repro.fed import schedulers as j_sched
from repro.fed import session as j_session
from repro.fed import simulation as j_sim
from repro.models import model as j_model
from repro.serve import AdapterRegistry as JRegistry
from repro.serve import SelfDrafter as JSelf
from repro.serve import ServeEngine as JEngine
from repro.serve.oracle import make_demo_adapter as j_demo_adapter
import repro_torch.obs as T
from repro_torch import interop
from repro_torch.configs import get_reduced
from repro_torch.fed import schedulers as t_sched
from repro_torch.fed import session as t_session
from repro_torch.fed import simulation as t_sim
from repro_torch.obs import recorder as t_recorder
from repro_torch.serve import AdapterRegistry, SelfDrafter, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
TRACKS = ("serve/engine", "serve/req0", "serve/req1", "fed.server",
          "fed.wire")
INSTANTS = ("first_token", "finish", "preempt", "update_arrival", "admit")
# the engine's only time-valued args: TTFT on first_token and slo_miss
TIME_KEYS = {"first_token": ("ttft_s",), "slo_miss": ("ttft_s",)}
RANKS = (2, 4, 6, 8)
STEPS = 10
# "tight" misses every time (no TTFT is 1 ns), "loose" attains every time
SLO = {"tight": 1e-9, "loose": 1e6}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread avoids thread-pool
    overhead and contention with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# module parity on seeded events
# ---------------------------------------------------------------------------

def _events(seed: int, n: int = 120):
    """``n`` events over ``TRACKS``: sequential non-overlapping spans per
    track, instants (some carrying the routed values), counter samples;
    host scalars only, as a recorder holds them."""
    rng = np.random.default_rng(seed)
    t = float(rng.uniform(100.0, 200.0))
    free = {tr: t for tr in TRACKS}
    out = []
    for _ in range(n):
        track = TRACKS[int(rng.integers(len(TRACKS)))]
        kind = ("X", "i", "C")[int(rng.integers(3))]
        t = max(t, free[track]) + float(rng.exponential(0.05))
        if kind == "X":
            dur = float(rng.exponential(0.1))
            out.append(("X", f"step{int(rng.integers(3))}", track, t, dur,
                        {"batch": int(rng.integers(1, 9))}))
            free[track] = t + dur
        elif kind == "i":
            name = INSTANTS[int(rng.integers(len(INSTANTS)))]
            args = {"ttft_s": float(rng.uniform(0, 0.4)),
                    "tokens": int(rng.integers(1, 64)),
                    "staleness": int(rng.integers(0, 5)),
                    "pages_freed": int(rng.integers(0, 9)),
                    "row": int(rng.integers(8))}
            out.append(("i", name, track, t, 0.0, args))
        else:
            name = ("fed.uplink_bytes", "serve.pages.free")[
                int(rng.integers(2))]
            out.append(("C", name, track, t, 0.0,
                        {name: int(rng.integers(0, 10_000))}))
    return out


def _registries(seed: int):
    """The same counters, gauges and histograms in both packages."""
    rng = np.random.default_rng(seed)
    regs = (J.MetricsRegistry(), T.MetricsRegistry())
    for i in range(4):
        v, g = int(rng.integers(100)), int(rng.integers(50))
        xs = rng.exponential(0.02, size=int(rng.integers(1, 30)))
        for reg in regs:
            reg.counter(f"serve.c{i}").inc(v)
            reg.gauge(f"serve.pages.g{i}").set(g)
            for x in xs:
                reg.histogram(f"serve.h{i}_s").observe(float(x))
    for reg in regs:
        reg.histogram("serve.empty_s")
    return regs


OBJECTIVES = [("ttft", "first_token.ttft_s", 0.2, 0.9, True),
              ("tokens", "finish.tokens", 8.0, 0.5, False),
              ("steps", "span.step1", 0.05, 0.99, True)]


def _slo(pkg, rec=None):
    return pkg.SLOMonitor([pkg.Objective(n, s, th, target=tg,
                                         lower_is_better=lo)
                           for n, s, th, tg, lo in OBJECTIVES],
                          recorder=rec, bucket_s=0.5, window_buckets=40)


def test_obs_exports_the_reference_names():
    assert T.__all__ == J.__all__
    assert all(hasattr(T, name) for name in T.__all__)


@pytest.mark.parametrize("seed,dropped", [(0, 0), (1, 7), (2, 0)])
def test_exporters_match_reference(tmp_path, seed, dropped):
    events = _events(seed)
    doc = T.chrome_trace(events, "p", dropped=dropped)
    assert doc == J.chrome_trace(events, "p", dropped=dropped)
    assert T.validate_chrome_trace(doc) == J.validate_chrome_trace(doc)
    assert T.validate_chrome_trace(doc)["dropped"] == dropped
    meta = {"dropped": dropped, "seed": seed}
    tp, jp = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    assert T.write_jsonl(events, str(tp), meta=meta) == len(events)
    J.write_jsonl(events, str(jp), meta=meta)
    assert tp.read_bytes() == jp.read_bytes()
    assert J.read_jsonl_with_meta(str(tp)) == (events, meta)
    assert T.read_jsonl_with_meta(str(jp)) == (events, meta)
    assert T.read_jsonl(str(jp)) == events
    tc, jc = tmp_path / "t.json", tmp_path / "j.json"
    T.write_chrome_trace(events, str(tc), dropped=dropped)
    J.write_chrome_trace(events, str(jc), dropped=dropped)
    assert tc.read_bytes() == jc.read_bytes()


@pytest.mark.parametrize("seed", [0, 3])
def test_series_slo_report_and_summary_match_reference(tmp_path, seed):
    events = _events(seed, 200)
    jreg, treg = _registries(seed)
    assert treg.summary_text("m") == jreg.summary_text("m")
    assert treg.as_dict() == jreg.as_dict()
    assert treg.has("serve.c0") and not treg.has("serve.none")
    assert set(treg.gauges()) == set(jreg.gauges())
    stores = (J.SeriesStore(bucket_s=0.25, max_buckets=16),
              T.SeriesStore(bucket_s=0.25, max_buckets=16))
    counts = [s.fold(events) for s in stores]
    assert counts[0] == counts[1]
    t_end = events[-1][3]
    assert stores[1].sample_gauges(treg, t_end, prefix="serve.pages") == \
        stores[0].sample_gauges(jreg, t_end, prefix="serve.pages") == 4
    assert stores[1].as_dict() == stores[0].as_dict()
    assert any(v["dropped"] for v in stores[1].as_dict().values())
    assert list(T.iter_observations(events)) == \
        list(J.iter_observations(events))
    jrec, trec = J.Recorder(), T.Recorder()
    jslo, tslo = _slo(J, jrec), _slo(T, trec)
    assert tslo.fold(events) == jslo.fold(events)
    assert tslo.as_dict(now=t_end) == jslo.as_dict(now=t_end)
    assert tslo.violations == jslo.violations
    assert tslo.violations              # the thresholds make some
    assert [e[:3] + e[4:] for e in trec.events()] == \
        [e[:3] + e[4:] for e in jrec.events()]
    assert {e[2] for e in trec.events()} == {T.SLO_TRACK} == {J.SLO_TRACK}
    # the report evaluates its monitor without ``now``: the port's and the
    # reference's SLO state depend on the window only, not on the clock
    kw = dict(title="ops", dropped=3)
    t_html = T.render_html(store=stores[1], slo=tslo, metrics=treg, **kw)
    assert t_html == J.render_html(store=stores[0], slo=jslo, metrics=jreg,
                                   **kw)
    assert T.snapshot_text(stores[1], tslo, treg, title="s") == \
        J.snapshot_text(stores[0], jslo, jreg, title="s")
    assert T.sparkline_svg([1.0, 3.0, 2.0]) == J.sparkline_svg([1.0, 3.0,
                                                                 2.0])
    # each evaluation appends its violations, so the written report lists
    # more than the rendered one did: held against the reference's again
    tp, jp = tmp_path / "t.html", tmp_path / "j.html"
    assert T.write_html(str(tp), store=stores[1], slo=tslo, metrics=treg,
                        **kw) == str(tp)
    J.write_html(str(jp), store=stores[0], slo=jslo, metrics=jreg, **kw)
    assert tp.read_text() == jp.read_text()
    assert "dropped <b>3</b>" in t_html and "VIOLATED" in t_html


@settings(deadline=None, max_examples=25)
@given(seed=st.integers(0, 2**31 - 1),
       bucket_s=st.sampled_from([0.01, 0.1, 0.37, 2.0]),
       max_buckets=st.integers(1, 64))
def test_time_series_fold_matches_reference_and_conserves_mass(
        seed, bucket_s, max_buckets):
    events = _events(seed, 60)
    t = T.SeriesStore(bucket_s, max_buckets)
    j = J.SeriesStore(bucket_s, max_buckets)
    t.fold(events)
    j.fold(events)
    assert t.as_dict() == j.as_dict()
    for name in t.names():
        s = t.series(name)
        assert s.window_count() + s.dropped == s.count
        assert [tuple(b) for b in s.buckets()] == \
            [tuple(b) for b in j.series(name).buckets()]
        if not s.dropped:
            assert math.isclose(s.window_total(), s.total, rel_tol=1e-12,
                                abs_tol=1e-12)


def test_rebase_and_merge_match_reference():
    parent, child = _events(5, 40), _events(6, 40)
    php = {"process": "parent", "perf": 10.0, "wall": 1.7e9}
    chs = {"process": "c1", "perf": 3.5, "wall": 1.7e9 + 2.25, "dropped": 0}
    assert T.rebase_events(child, chs, php, "x/") == \
        J.rebase_events(child, chs, php, "x/")
    merged = T.merge_streams(parent, [(child, chs)], php)
    assert merged == J.merge_streams(parent, [(child, chs)], php)
    T.validate_chrome_trace(T.chrome_trace(merged))
    with pytest.raises(ValueError, match="handshake"):
        T.merge_streams(parent, [(child, None)], php)


def test_ring_drops_oldest_first_and_both_exporters_count_it(tmp_path):
    recs = (T.Recorder(capacity=4), J.Recorder(capacity=4))
    for rec in recs:
        for i in range(10):
            rec.instant("e", "t", i=i)
    trec, jrec = recs
    assert [e[5]["i"] for e in trec.events()] == [6, 7, 8, 9]
    assert trec.dropped == jrec.dropped == 6 and len(trec) == 4
    assert trec.appended == 10
    doc = T.chrome_trace(trec.events(), dropped=trec.dropped)
    assert T.validate_chrome_trace(doc)["dropped"] == 6
    assert J.validate_chrome_trace(doc)["dropped"] == 6
    hs = T.dump_stream(trec, str(tmp_path / "c.jsonl"), process="ring")
    assert hs["dropped"] == 6
    events, meta = J.read_jsonl_with_meta(str(tmp_path / "c.jsonl"))
    assert meta["handshake"]["dropped"] == 6 and len(events) == 4
    trec.clear()
    assert trec.dropped == 0 and trec.events() == []
    with pytest.raises(ValueError):
        T.Recorder(capacity=0)


def test_recorder_forms_and_the_null_recorder():
    rec = T.Recorder()
    t0 = rec.now()
    with rec.span("s", "a", k=1):
        rec.counter_sample("n", "a", 3)
    rec.complete("c", "b", t0, t0 - 1.0)          # clamped to 0
    kinds = [(e[0], e[1], e[2], e[5]) for e in rec.events()]
    assert kinds == [("C", "n", "a", {"n": 3}), ("X", "s", "a", {"k": 1}),
                     ("X", "c", "b", {})]
    assert rec.events()[2][4] == 0.0
    n = T.NULL_RECORDER
    assert not n.enabled and n.now() == 0.0 and len(n) == 0
    with n.span("x", "y"), n.annotation("z"):
        n.instant("a", "b")
    assert n.events() == [] and n.dropped == 0
    assert rec.annotation("q") is n.annotation("q")    # shared null ctx
    ann = T.Recorder(annotate=True).annotation("serve.decode_step")
    assert isinstance(ann, torch.profiler.record_function)


CHILD = """
import sys
from repro_torch.obs import Recorder, dump_stream
rec = Recorder()
t0 = rec.now()
for i in range(5):
    rec.complete("work", "main", t0 + i, t0 + i + 0.5, i=i)
rec.instant("done", "main", n=5)
dump_stream(rec, sys.argv[1], process="child0")
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "torch")))
"""


def test_collect_from_a_real_child_process(tmp_path):
    path = tmp_path / "child.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    parent = T.Recorder()
    before = parent.now()
    with parent.span("spawn", "parent"):
        out = subprocess.run([sys.executable, "-c", CHILD, str(path)],
                             capture_output=True, text=True, env=env,
                             timeout=120)
    after = parent.now()
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"          # obs imports nothing heavy
    events, hs = T.read_stream(str(path))
    assert hs["process"] == "child0" and hs["dropped"] == 0
    assert (events, hs) == J.read_stream(str(path))
    phs = T.clock_handshake("parent")
    merged = T.merge_streams(parent.events(), [(events, hs)], phs)
    assert merged == J.merge_streams(parent.events(), [(events, hs)], phs)
    kids = [e for e in merged if e[2].startswith("child0/")]
    assert len(kids) == 6 and all(e[2] == "child0/main" for e in kids)
    assert [e[4] for e in kids if e[0] == "X"] == [0.5] * 5
    # the child's first event falls inside the parent's spawn span, to the
    # handshake's accuracy (well under a millisecond on one host)
    start = min(e[3] for e in kids)
    assert before - 1e-3 <= start <= after + 1e-3
    counts = T.validate_chrome_trace(T.chrome_trace(merged))
    assert counts["X"] == 6 and counts["i"] == 1


# ---------------------------------------------------------------------------
# the recorded engine
# ---------------------------------------------------------------------------

def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


class Serving:
    """Reduced Gemma in both packages from the reference's weights, four
    adapters, and 8 prompts in two SLO classes on a 10-page pool, small
    enough that admissions defer and rows are preempted."""

    def __init__(self):
        self.jcfg, self.tcfg = j_get_reduced("gemma-2b"), \
            get_reduced("gemma-2b")
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
                       page_size=4, num_pages=10, prefill_chunk=4)

    def registries(self):
        jreg = JRegistry(self.jcfg, capacity=len(RANKS))
        treg = AdapterRegistry(self.tcfg, capacity=len(RANKS), device="cpu")
        for aid in self.jadapters:
            jreg.register(aid, self.jadapters[aid])
            treg.register(aid, self.tadapters[aid])
        return jreg, treg

    def engines(self, jrec, trec, self_draft=False):
        jreg, treg = self.registries()
        jd, td = (JSelf(1), SelfDrafter(1)) if self_draft else (None, None)
        return (JEngine(self.jparams, self.jcfg, jreg, use_pallas=False,
                        recorder=jrec, slo_ttft_s=SLO, drafter=jd,
                        **self.kw),
                ServeEngine(self.tparams, self.tcfg, treg, device="cpu",
                            recorder=trec, slo_ttft_s=SLO, drafter=td,
                            **self.kw))


@pytest.fixture(scope="module")
def serving():
    return Serving()


def _serve(engine, prompts):
    uids = [engine.submit(p, f"client{i % len(RANKS)}",
                          max_new_tokens=STEPS,
                          slo_class=("tight", "loose")[i % 2])
            for i, p in enumerate(prompts)]
    outs = engine.run()
    return [outs[u] for u in uids]


def _shape(events):
    """(phase, name, track, args without the time-valued keys)."""
    out = []
    for kind, name, track, _t0, _dur, args in events:
        keep = {k: v for k, v in args.items()
                if k not in TIME_KEYS.get(name, ())}
        out.append((kind, name, track, keep))
    return out


def _hold_time_args(events, engine):
    """Each side's time-valued args: finite, positive, and the TTFTs its
    own histogram observed, in order; every slo_miss past its target."""
    ttft = [e[5]["ttft_s"] for e in events if e[1] == "first_token"]
    assert all(math.isfinite(v) and v > 0 for v in ttft)
    h = engine.metrics.histogram("serve.ttft_s")
    assert h.count == len(ttft) and math.isclose(h.total, sum(ttft))
    for e in events:
        if e[1] == "slo_miss":
            assert e[5]["ttft_s"] > e[5]["target_s"]


def _counters(reg, reference: bool):
    """Counter and gauge values by name; the reference's page allocator
    names its shard (``serve.pages.shard0.*``, the port ``serve.pages.*``)
    and counts jit traces, which the eager port has not."""
    out = {}
    for name, v in reg.as_dict().items():
        if isinstance(v, dict):
            continue
        if reference:
            if name == "serve.traces":
                continue
            name = name.replace("serve.pages.shard0.", "serve.pages.")
        out[name] = v
    return out


HISTOGRAMS = ("serve.ttft_s", "serve.ttft_s.tight", "serve.ttft_s.loose",
              "serve.request_s", "serve.request_tok_s",
              "serve.decode_step_s")


@pytest.mark.parametrize("self_draft", [False, True])
def test_recorded_engine_matches_reference(serving, self_draft):
    jrec, trec = J.Recorder(), T.Recorder()
    jeng, teng = serving.engines(jrec, trec, self_draft)
    jout, tout = _serve(jeng, serving.prompts), _serve(teng, serving.prompts)
    plain = ServeEngine(serving.tparams, serving.tcfg,
                        serving.registries()[1], device="cpu",
                        drafter=SelfDrafter(1) if self_draft else None,
                        **serving.kw)
    want = _serve(plain, serving.prompts)
    for j, t, w in zip(jout, tout, want):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, w)
    assert teng.deferrals > 0 and teng.preemptions > 0
    tev, jev = trec.events(), jrec.events()
    assert _shape(tev) == _shape(jev)
    names = {e[1] for e in tev}
    assert {"submit", "admit", "defer", "extend", "preempt", "replay",
            "prefill_chunk", "first_token", "slo_miss", "finish"} <= names
    assert ({"draft", "verify_step"} if self_draft else {"decode_step"}) \
        <= names
    _hold_time_args(tev, teng)
    _hold_time_args(jev, jeng)
    assert _counters(teng.metrics, False) == _counters(jeng.metrics, True)
    for h in HISTOGRAMS:
        assert teng.metrics.histogram(h).count == \
            jeng.metrics.histogram(h).count > 0, h
    assert teng.metrics.histogram("serve.prefill_row_s").count == \
        sum(e[1] in ("admit", "replay") for e in tev)
    assert teng.slo_attainment() == jeng.slo_attainment() == \
        {"loose": 1.0, "tight": 0.0}
    assert not plain.metrics.has("serve.decode_step_s")
    assert plain.slo_attainment() == {}
    T.validate_chrome_trace(T.chrome_trace(tev))


def test_annotated_decode_steps_appear_in_the_profiler(serving):
    """``Recorder(annotate=True)``: one ``serve.decode_step`` range a
    decode step in a torch.profiler trace (on the CPU here)."""
    from torch.profiler import ProfilerActivity, profile
    rec = T.Recorder(annotate=True)
    _, eng = serving.engines(J.Recorder(), rec)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(eng, serving.prompts[:4])
    names = [e.name for e in prof.events()]
    assert names.count("serve.decode_step") == eng.steps > 0
    assert names.count("serve.prefill_chunk") == eng.prefill_calls


# ---------------------------------------------------------------------------
# the recorded round
# ---------------------------------------------------------------------------

SIM = dict(num_examples=128, eval_examples=64, rounds=1, local_steps=2,
           local_batch=8, lr=1e-3)
SERVER = dict(num_clients=6, clients_per_round=3, seed=0)


@pytest.fixture(scope="module")
def roberta():
    jcfg, tcfg = j_get_reduced("roberta-large"), get_reduced("roberta-large")
    jparams = j_model.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = interop.params_from_jax(_np_tree(jparams), tcfg, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams)


def _j_round(w, rec):
    sim, scfg = j_sim.SimConfig(**SIM), j_session.ServerConfig(**SERVER)
    kw, cohort_train, _, data_fn, _, eval_fn = j_sim.make_experiment_setup(
        w["jcfg"], sim, scfg, w["jparams"])
    sess = j_session.FedSession(
        w["jcfg"], scfg, engine=j_engine.AggregationEngine(use_pallas=False),
        recorder=rec, **kw)
    hist = j_sched.SyncRound().run(sess, cohort_train, data_fn, 1,
                                   eval_fn=eval_fn)
    return sess, hist


def _t_round(w, rec):
    sim, scfg = t_sim.SimConfig(**SIM), t_session.ServerConfig(**SERVER)
    kw, cohort_train, _, data_fn, _, eval_fn = t_sim.make_experiment_setup(
        w["tcfg"], sim, scfg, w["tparams"], device="cpu")
    sess = t_session.FedSession(w["tcfg"], scfg, recorder=rec,
                                device="cpu", **kw)
    hist = t_sched.SyncRound().run(sess, cohort_train, data_fn, 1,
                                   eval_fn=eval_fn)
    return sess, hist


def test_recorded_round_matches_reference(roberta):
    jrec, trec = J.Recorder(), T.Recorder()
    jsess, jhist = _j_round(roberta, jrec)
    tsess, thist = _t_round(roberta, trec)
    _, plain = _t_round(roberta, None)
    tev, jev = trec.events(), jrec.events()
    assert _shape(tev) == _shape(jev)
    assert [(e[1], e[2]) for e in tev if e[0] == "X"] == [
        ("broadcast", "fed.server"), ("train", "fed.train"),
        ("collect", "fed.server"), ("aggregate", "fed.server"),
        ("round0", "fed.rounds")]
    wire = {}
    for e in tev:
        if e[0] == "C":
            wire[e[1]] = wire.get(e[1], 0) + e[5][e[1]]
    assert wire == {f"fed.{d}_bytes": sum(v)
                    for d, v in tsess.comm_log.items()}
    assert tsess.metrics.as_dict().keys() == jsess.metrics.as_dict().keys()
    assert {k: v for k, v in tsess.metrics.as_dict().items()
            if not isinstance(v, dict)} == \
        {k: v for k, v in jsess.metrics.as_dict().items()
         if not isinstance(v, dict)}
    assert tsess.metrics.histogram("fed.round_s").count == 1
    # the recorder changes nothing the round computes
    assert thist == plain
    for k in ("round", "downlink_bytes", "uplink_bytes", "health"):
        assert thist[k] == jhist[k], k


def test_health_anomaly_is_recorded_on_the_slo_track(roberta):
    """Three flat rounds of wire bytes, then a jump: the snapshot z-scores
    it and both packages record the same ``health_anomaly`` instant."""
    rows = []
    for pkg, sess_mod, w, kw in (
            (T, t_session, roberta["tparams"], dict(device="cpu")),
            (J, j_session, roberta["jparams"], {})):
        cfg = roberta["tcfg"] if pkg is T else roberta["jcfg"]
        rec = pkg.Recorder()
        sess = sess_mod.FedSession(cfg, sess_mod.ServerConfig(**SERVER), w,
                                   recorder=rec, **kw)
        for nbytes in (100, 110, 90, 100, 5000):
            sess._log_comm("downlink", nbytes)
            sess._log_comm("uplink", nbytes)
            sess.health_snapshot()
        rows.append([e[:3] + e[4:] for e in rec.events() if e[0] == "i"])
    assert rows[0] == rows[1]
    assert [r[1:3] for r in rows[0]] == [("health_anomaly", "obs.slo")] * 2
    assert sess.metrics.counter("fed.health.anomalies").value == 2


# ---------------------------------------------------------------------------
# no clock without a recorder
# ---------------------------------------------------------------------------

def _no_clock(*_args):
    raise AssertionError("clock read with recording off")


class _NoClock:
    """Stands in for the recorder module's ``time``: every read raises."""

    def __getattr__(self, name):
        return _no_clock


def test_null_recorder_reads_no_clock(monkeypatch, serving, roberta):
    """With the recorder's clock made to raise, an unrecorded engine (plain
    and speculative) and an unrecorded round run to their end."""
    monkeypatch.setattr(t_recorder, "time", _NoClock())
    for name in ("now", "wall"):
        monkeypatch.setattr(t_recorder.Recorder, name,
                            staticmethod(_no_clock))
    with pytest.raises(AssertionError, match="clock read"):
        T.Recorder().instant("x", "y")
    for drafter in (None, SelfDrafter(1)):
        eng = ServeEngine(serving.tparams, serving.tcfg,
                          serving.registries()[1], device="cpu",
                          drafter=drafter, slo_ttft_s=SLO, **serving.kw)
        assert len(_serve(eng, serving.prompts[:4])) == 4
        assert eng.rec is T.NULL_RECORDER and eng.slo_attainment() == {}
    sess, hist = _t_round(roberta, None)
    assert sess.rec is T.NULL_RECORDER and len(hist["round"]) == 1


def test_clock_discipline_finds_nothing_in_the_port():
    assert run_paths([str(ROOT / "src" / "repro_torch")],
                     rules=["clock-discipline"]) == []
