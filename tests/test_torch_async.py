"""The port's semi-synchronous and buffered asynchronous federation against
the reference's, on the CPU: ``FedSession.flush_async`` / ``adapter_for``,
``SemiSync``, ``BufferedAsync`` (through ``run_experiment`` and directly),
mid-flight checkpoints, the deprecated shims ``FedServer`` /
``AsyncFedServer`` / ``simulate_async_rounds``, on roberta-reduced (2
layers, d_model 128, LoRA on q and v at r_max 8), both sides from the
reference's weights and the reference session's initial global adapter
(``tests/test_torch_session.py``'s fixtures and limits).

Integers are held exactly everywhere: event times and client ids, versions,
``staleness_log``, accepted flags, ``flush_events``, cohorts, survivors,
stragglers, simulated round times, byte columns, counters and η (float32
from the same float64 weights on the host). Floats are held per merge in
an **anchored** run, whose session is put back on the reference's global
adapter and head after each of its merges, so each merge starts from the
same state: a merge whose inputs hold fewer than r_max directions above
float32 noise leaves the SVD's basis for the rest arbitrary, and a later
client of high rank trains on those directions (the reason
``tests/test_torch_session.py`` anchors its rounds). The limits are that
file's: the effective global update (alpha / r_max) A B normwise 1e-4 of
the reference's (``UPDATE_REL``), ``last_spectrum`` rtol 1e-4 with a floor
of 1e-6 of σ_1, heads and losses rtol 1e-4 / atol 1e-5 (``LOSS``).
``randomized`` draws its test matrix from a ``torch.Generator``, not the
reference's key: every flush here keeps rank ΔW' ≤ r_max + its oversample
of 8, where ``svd_randomized`` is exact to float precision, so it is held
to the same limits. The port's own splits (a mid-flight resume, an
infinite deadline) are held bit for bit.
"""
import heapq
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agg_engine as j_engine
from repro.fed import async_server as j_async_server
from repro.fed import schedulers as j_sched
from repro.fed import session as j_session
from repro.fed import simulation as j_sim
from repro.obs import Recorder as JRecorder
from repro_torch import interop
from repro_torch.core import agg_engine as t_engine
from repro_torch.data import client_batches, make_pair_classification
from repro_torch.fed import async_server as t_async_server
from repro_torch.fed import schedulers as t_sched
from repro_torch.fed import server as t_server
from repro_torch.fed import session as t_session
from repro_torch.fed import simulation as t_sim
from repro_torch.obs import Recorder
from test_torch_session import (LOSS, SERVER, SIM, UPDATE_REL,  # noqa: F401
                                _effective, _initial_lora, _normwise, _numpy,
                                _one_torch_thread, _spectrum_close, weights)

SPEEDS = np.linspace(0.5, 2.0, SERVER["num_clients"])
TRAINED_REL = 1e-2
SIZES = [40, 3, 77, 12, 9, 120]


class _Engines:
    """An engine of each package that counts its calls and keeps the η of
    each (the reference's runs its plain path, as the port's tests do)."""

    @staticmethod
    def reference():
        class Counting(j_engine.AggregationEngine):
            def __call__(self, tree, eta, *a, **kw):
                self.etas.append(np.asarray(eta))
                return super().__call__(tree, eta, *a, **kw)
        eng = Counting(use_pallas=False)
        eng.etas = []
        return eng

    @staticmethod
    def port():
        class Counting(t_engine.AggregationEngine):
            def __call__(self, tree, eta, *a, **kw):
                self.etas.append(torch.as_tensor(eta).numpy().copy())
                return super().__call__(tree, eta, *a, **kw)
        eng = Counting()
        eng.etas = []
        return eng


def _hold_merge(weights, want, got, what):
    """One merge's floats: the effective global update, the spectrum and
    the head."""
    cfg = weights["tcfg"]
    ew = _effective(want["lora"], cfg.lora.alpha, cfg.lora.r_max)
    eg = _effective(got["lora"], cfg.lora.alpha, cfg.lora.r_max)
    for t in ew:
        _normwise(eg[t], ew[t], UPDATE_REL, f"{what} {t}")
    assert (want["spectrum"] is None) == (got["spectrum"] is None), what
    if want["spectrum"] is not None:
        _spectrum_close(got["spectrum"], want["spectrum"], what)
    for k, v in want["head"].items():
        np.testing.assert_allclose(got["head"][k], v, **LOSS,
                                   err_msg=f"{what} head {k}")


def _holder(weights):
    return lambda want, got, what: _hold_merge(weights, want, got, what)


def _state(session):
    spec = session.last_spectrum
    return dict(lora=_numpy(session.global_lora),
                head=_numpy(session.global_head),
                spectrum=None if spec is None else _numpy(spec))


def _hold_trained(want, got, what):
    """A client's trained update (tree, head) against the reference's from
    the same state and batches, leaf by leaf, normwise to ``TRAINED_REL``
    of the reference's leaf."""
    (wt, wh), (gt, gh) = want, got
    pairs = [(f"{t} {leaf}", wt[t][leaf], gt[t][leaf])
             for t in wt for leaf in ("A", "B")]
    pairs += [(f"head {k}", wh[k], gh[k]) for k in wh]
    for name, w, g in pairs:
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= TRAINED_REL, (what, name, err)
    for t in wt:
        np.testing.assert_array_equal(gt[t]["mask"], wt[t]["mask"])


def _logging(session, book, anchors=None, hold=None):
    """Wrap a session's ``make_update`` (log each async update's client,
    start version, tree and head; ``collect_updates``' calls, with
    ``log=False``, pass through) and ``flush_async`` (log the flags and the
    state after it). With ``anchors``, the reference's log: hold each
    update against the reference's (``_hold_trained``) and send the
    reference's in its place, then hold each merge with ``hold`` and put
    the reference's state in place after it."""
    make_update, flush = session.make_update, session.flush_async

    def make_update_logged(cid, tree, start_version, head=None, log=True):
        if not log:
            return make_update(cid, tree, start_version, head, log)
        i = len(book["updates"])
        book["updates"].append((int(cid), int(start_version)))
        book["trained"].append((_numpy(tree), _numpy(head or {})))
        if anchors is not None:
            _hold_trained(anchors["trained"][i], book["trained"][i],
                          f"update {i}")
            tree, head = (interop.tree_from_numpy(x, "cpu")
                          for x in anchors["trained"][i])
        return make_update(cid, tree, start_version, head)

    def flush_logged(updates):
        flags = flush(updates)
        i = len(book["flushes"])
        book["flushes"].append(dict(_state(session), flags=flags,
                                   version=session.version))
        if anchors is not None and any(flags):
            hold(anchors["flushes"][i], book["flushes"][i], f"flush {i}")
            prev = anchors["flushes"][i]
            session.global_lora = interop.lora_from_jax(prev["lora"], "cpu")
            session.global_head = interop.tree_from_numpy(prev["head"],
                                                          "cpu")
        return flags

    for key in ("updates", "trained", "flushes"):
        book.setdefault(key, [])
    session.make_update = make_update_logged
    session.flush_async = flush_logged


def _recording(base, initial=None, anchors=None, hold=None, **fields):
    """A scheduler of class ``base`` (either package's) whose run logs the
    session's updates and flushes (``_logging``), and each round's cohort,
    survivors and collected stack; ``initial``: the global adapter the
    port's session starts from; ``anchors``: the reference's log, whose
    state after round i is put in place before round i + 1's broadcast,
    and whose trained survivors are collected in place of the port's once
    those are held to them (``_hold_trained``, client by client)."""

    class Recording(base):
        def run(self, session, *args, **kw):
            self.log = {"cohorts": [], "collected": [], "stacks": [],
                        "merges": []}
            self.session = session
            if initial is not None:
                session.global_lora = interop.lora_from_jax(initial, "cpu")
            _logging(session, self.log, anchors, hold)
            broadcast, collect, merge = (session.broadcast_cohort,
                                         session.collect_updates,
                                         session.aggregate_round)

            def broadcast_logged(cohort):
                self.log["cohorts"].append([int(c) for c in cohort])
                done = session.rounds_done
                if anchors is not None and done > 0:
                    prev = anchors["merges"][done - 1]
                    session.global_lora = interop.lora_from_jax(
                        prev["lora"], "cpu")
                    session.global_head = interop.tree_from_numpy(
                        prev["head"], "cpu")
                return broadcast(cohort)

            def collect_logged(cohort, tree, heads=None):
                i = len(self.log["collected"])
                self.log["collected"].append([int(c) for c in cohort])
                self.log["stacks"].append((_numpy(tree), _numpy(heads or {})))
                if anchors is not None:
                    (wt, wh), (gt, gh) = anchors["stacks"][i], \
                        self.log["stacks"][i]
                    for k in range(len(cohort)):
                        _hold_trained(*(
                            ({t: {x: v[k] for x, v in ad.items()}
                              for t, ad in tr.items()},
                             {x: v[k] for x, v in hd.items()})
                            for tr, hd in ((wt, wh), (gt, gh))),
                            f"round {i} client {cohort[k]}")
                    tree = interop.tree_from_numpy(wt, "cpu")
                    heads = interop.tree_from_numpy(wh, "cpu") or None
                return collect(cohort, tree, heads)

            def merge_logged(tree, cohort, **kw2):
                merge(tree, cohort, **kw2)
                self.log["merges"].append(_state(session))

            session.broadcast_cohort = broadcast_logged
            session.collect_updates = collect_logged
            session.aggregate_round = merge_logged
            return super().run(session, *args, **kw)

    return Recording(**fields)


@pytest.fixture(scope="module")
def setups(weights):
    """Each package's trainers, data and eval for ``SERVER`` and ``SIM``,
    built once (the reference's jitted trainers compile once). The async
    runs take ``stateless``'s batches, which depend on the client and its
    version alone (``make_experiment_setup``'s ``client_data_fn`` draws
    from one rng in call order, which differs from run to run)."""
    scfg = dict(SERVER)
    j = j_sim.make_experiment_setup(weights["jcfg"], j_sim.SimConfig(**SIM),
                                    j_session.ServerConfig(**scfg),
                                    weights["jparams"])
    t = t_sim.make_experiment_setup(weights["tcfg"], t_sim.SimConfig(**SIM),
                                    t_session.ServerConfig(**scfg),
                                    weights["tparams"], device="cpu")
    tokens, labels = make_pair_classification(
        "mrpc", SIM["num_examples"], seed=0,
        vocab_size=weights["tcfg"].vocab_size)
    shards = np.array_split(np.random.default_rng(0).permutation(
        SIM["num_examples"]), SERVER["num_clients"])
    calls = {}

    def stateless(cid):
        n = calls[cid] = calls.get(cid, 0) + 1
        return client_batches(tokens, labels, shards[cid], SIM["local_steps"],
                              SIM["local_batch"], seed=1000 * n + cid)

    def fresh_data():
        calls.clear()
        return stateless

    names = ("kw", "cohort_train", "local_train", "data_fn", "client_data_fn",
             "eval_fn")
    return dict(reference=dict(zip(names, j)), port=dict(zip(names, t)),
                data=fresh_data)


def _sessions(weights, server=None, engines=True, **kw):
    """A reference and a port session of ``SERVER`` (updated by
    ``server``), the port's on the reference's initial adapter."""
    server = dict(SERVER, **(server or {}))
    jkw, tkw = dict(kw), dict(kw)
    if engines:
        jkw["engine"], tkw["engine"] = _Engines.reference(), _Engines.port()
    if "acfg" in kw:
        jkw["acfg"] = j_session.AsyncConfig(**vars(kw["acfg"]))
    j = j_session.FedSession(weights["jcfg"], j_session.ServerConfig(
        **server), weights["jparams"], client_sizes=SIZES, **jkw)
    t = t_session.FedSession(weights["tcfg"], t_session.ServerConfig(
        **server), weights["tparams"], client_sizes=SIZES, device="cpu",
        **tkw)
    t.global_lora = interop.lora_from_jax(_initial_lora(weights, server),
                                          "cpu")
    return j, t


# ---------------------------------------------------------------------------
# flush_async alone
# ---------------------------------------------------------------------------

def _numpy_update(rng, cfg, rank, head_like):
    """A trained-looking full-rank tree masked to ``rank``, and a head."""
    r_max, tree = cfg.lora.r_max, {}
    from repro_torch.models.transformer import lora_specs
    for t, (d_in, d_out) in lora_specs(cfg).items():
        m = np.broadcast_to((np.arange(r_max) < rank).astype(np.float32),
                            (cfg.num_layers, r_max)).copy()
        a = rng.standard_normal((cfg.num_layers, d_in, r_max)) * 0.1
        b = rng.standard_normal((cfg.num_layers, r_max, d_out)) * 0.05
        tree[t] = {"A": (a * m[:, None, :]).astype(np.float32),
                   "B": (b * m[:, :, None]).astype(np.float32), "mask": m}
    head = {k: (np.asarray(v) + 0.01 * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in head_like.items()}
    return tree, head


# (client, rank, start version) of each flush, the sessions at version 20
# and max_staleness 16: K = 4 with one update 17 versions old (dropped),
# then K = 1 fresh, then K = 1 22 versions old (dropped, nothing merges).
# The updates' ranks with the global's 8 stay within r_max + 8.
FLUSHES = ([(0, 2, 20), (3, 3, 18), (5, 8, 3), (2, 3, 15)],
           [(4, 4, 23)],
           [(1, 6, 2)])


@pytest.mark.parametrize("method", ["factored", "exact", "randomized"])
def test_flush_async_matches_reference(weights, method):
    """The same numpy updates through both packages' ``make_update`` and
    ``flush_async`` at K = 4 and K = 1 from a trained-looking global (B
    drawn at 0.05): flags, staleness, version, counters, uplink bytes and
    η equal, the merge within the module's limits."""
    acfg = t_session.AsyncConfig(max_staleness=16)
    j, t = _sessions(weights, dict(svd_method=method), acfg=acfg)
    rng = np.random.default_rng(7)
    lora = _initial_lora(weights, SERVER)
    for ad in lora.values():
        ad["B"] = (0.05 * rng.standard_normal(ad["B"].shape)).astype(
            np.float32)
    j.global_lora = jax.tree.map(jnp.asarray, lora)
    t.global_lora = interop.lora_from_jax(lora, "cpu")
    j.version = t.version = 20
    head0 = _numpy(t.global_head)
    for n, flush in enumerate(FLUSHES):
        jups, tups = [], []
        for cid, rank, start in flush:
            tree, head = _numpy_update(rng, weights["tcfg"], rank, head0)
            jups.append(j.make_update(cid, jax.tree.map(jnp.asarray, tree),
                                      start, head=head))
            tups.append(t.make_update(cid, interop.tree_from_numpy(
                tree, "cpu"), start, head=interop.tree_from_numpy(head,
                                                                  "cpu")))
        assert [u.to_bytes() for u in tups] == [u.to_bytes() for u in jups]
        jflags, tflags = j.flush_async(jups), t.flush_async(tups)
        assert tflags == jflags and (len(flush) == 1 or jflags.count(False)
                                     == 1), n
        assert t.staleness_log == j.staleness_log
        assert t.version == j.version
        assert t.comm_log == j.comm_log
        for name in ("fed.updates_merged", "fed.updates_dropped"):
            assert t.metrics.counter(name).value == \
                j.metrics.counter(name).value, name
        th, jh = (s.metrics.histogram("fed.staleness") for s in (t, j))
        assert (th.count, th.total) == (jh.count, jh.total)
        assert len(t.engine.etas) == len(j.engine.etas)
        if not any(jflags):
            continue
        np.testing.assert_array_equal(t.engine.etas[-1], j.engine.etas[-1])
        _hold_merge(weights, _state(j), _state(t), f"{method} flush {n}")
        t.global_lora = interop.lora_from_jax(_numpy(j.global_lora), "cpu")
        t.global_head = interop.tree_from_numpy(_numpy(j.global_head), "cpu")
    assert t.version == 24 and len(t.engine.etas) == 2
    assert t.staleness_log == [0, 2, 17, 5, 0, 22]


# ---------------------------------------------------------------------------
# BufferedAsync
# ---------------------------------------------------------------------------

def _hold_async(jsched, jhist, tsched, thist):
    """The integers of two BufferedAsync runs: event times, clients and
    versions, staleness, flags, flushes, byte columns, health rows."""
    for k in ("time", "staleness", "accepted", "flush_events",
              "downlink_bytes", "uplink_bytes", "health"):
        assert thist[k] == jhist[k], k
    assert tsched.log["updates"] == jsched.log["updates"]
    assert [f["flags"] for f in tsched.log["flushes"]] == \
        [f["flags"] for f in jsched.log["flushes"]]
    assert [f["version"] for f in tsched.log["flushes"]] == \
        [f["version"] for f in jsched.log["flushes"]]
    for s in (jsched.session, tsched.session):
        assert s.staleness_log == jhist["staleness"]
    assert len(thist["eval_acc"]) == len(jhist["eval_acc"])
    np.testing.assert_allclose(thist["eval_loss"][:1], jhist["eval_loss"][:1],
                               **LOSS)


def test_buffered_async_run_experiment_matches_reference(weights):
    """``run_experiment(scheduler=BufferedAsync(...))``: SIM's 3 rounds of
    3 clients are 9 events, merged 2 at a time (the last alone, drained),
    evaluated every 3 events and after the last. A free port run keeps
    every integer and the updates before the first flush; an anchored one
    holds every update and every flush."""
    acfg = dict(base_weight=0.5)

    def run(pkg, initial=None, anchors=None):
        mod_sched, mod_sim, mod_sess = (
            (j_sched, j_sim, j_session) if pkg == "reference"
            else (t_sched, t_sim, t_session))
        sched = _recording(
            mod_sched.BufferedAsync, initial, anchors,
            _holder(weights), speeds=SPEEDS, buffer_size=2,
            acfg=mod_sess.AsyncConfig(**acfg))
        kw = dict(engine=j_engine.AggregationEngine(use_pallas=False)) \
            if pkg == "reference" else dict(device="cpu")
        hist = mod_sim.run_experiment(
            weights["jcfg" if pkg == "reference" else "tcfg"],
            mod_sim.SimConfig(**SIM), mod_sess.ServerConfig(**SERVER),
            base_params=weights["jparams" if pkg == "reference"
                                else "tparams"], scheduler=sched, **kw)
        return sched, hist

    jsched, jhist = run("reference")
    initial = _initial_lora(weights, SERVER)
    tsched, thist = run("port", initial)
    _hold_async(jsched, jhist, tsched, thist)
    assert thist["flush_events"] == [2, 2, 2, 2, 1]
    assert len(thist["eval_acc"]) == 4            # events 0, 3, 6 and 8
    for i in range(2):            # trained from the same initial state
        _hold_trained(jsched.log["trained"][i], tsched.log["trained"][i],
                      f"free update {i}")
    asched, ahist = run("port", initial, jsched.log)
    _hold_async(jsched, jhist, asched, ahist)
    np.testing.assert_allclose(ahist["eval_loss"], jhist["eval_loss"], **LOSS)
    assert asched.session.acfg == t_session.AsyncConfig()   # scoped to run


@pytest.mark.parametrize("k", [1, 3])
def test_buffered_async_direct_matches_reference(weights, setups, k):
    """``BufferedAsync(buffer_size=k).run`` on a session of each package
    with the shared trainers and ``stateless`` batches: 7 events, an eval
    every 3, the scheduler's ``acfg`` (max_staleness 1) scoped to the run
    over the session's (max_staleness 2), one engine call a flush that
    keeps an update (none for a flush that drops them all), both
    runs recording: the same events, tracks and arguments (times aside)."""
    jrec, trec = JRecorder(), Recorder()
    j, t = _sessions(weights, acfg=t_session.AsyncConfig(max_staleness=2))
    j.rec, t.rec = jrec, trec
    own = (j.acfg, t.acfg)
    runs = {}
    for pkg, sess in (("reference", j), ("port", t)):
        setup = setups[pkg]
        mod_sched, mod_sess = (j_sched, j_session) if pkg == "reference" \
            else (t_sched, t_session)
        sched = _recording(
            mod_sched.BufferedAsync, None,
            None if pkg == "reference" else runs["reference"][0].log,
            _holder(weights), speeds=SPEEDS, buffer_size=k,
            acfg=mod_sess.AsyncConfig(max_staleness=1, base_weight=0.5))
        hist = sched.run(sess, setup["local_train"], setups["data"](), 7,
                         eval_fn=setup["eval_fn"], eval_every=3)
        runs[pkg] = (sched, hist)
    _hold_async(*runs["reference"], *runs["port"])
    thist = runs["port"][1]
    assert (j.acfg, t.acfg) == own and t.acfg.max_staleness == 2
    assert not all(thist["accepted"])             # max_staleness 1 cut some
    merged = sum(any(f["flags"]) for f in runs["port"][0].log["flushes"])
    assert len(t.engine.etas) == len(j.engine.etas) == merged > 0
    assert len(thist["flush_events"]) == len(runs["port"][0].log["flushes"])
    assert sum(thist["flush_events"]) == 7
    assert len(thist["eval_acc"]) == 3            # events 0, 3 and 6 (last)
    np.testing.assert_allclose(thist["eval_loss"], runs["reference"][1][
        "eval_loss"], **LOSS)

    def shape(events):
        return [(e[0], e[1], e[2], e[5]) for e in events]
    assert shape(trec.events()) == shape(jrec.events())
    names = {(e[1], e[2]) for e in trec.events()}
    assert ("flush", "fed.server") in names
    assert any(n == "update_arrival" and tr.startswith("fed.client")
               for n, tr in names)


def test_client_training_leaves_the_session_state_alone(weights, setups):
    """Aliasing: a client's training (the port's in-place-free AdamW over
    detached leaves) leaves ``global_head``, the global adapter, every
    other client's pending adapter and every buffered update's tensors bit
    for bit unchanged until the next flush; the pending adapters share no
    storage with the global adapter or with each other."""
    _, t = _sessions(weights)
    local = setups["port"]["local_train"]
    data = setups["data"]()

    def snap(tree):
        return {k: snap(v) for k, v in tree.items()} if isinstance(
            tree, dict) else tree.clone()

    def same(a, b):
        if isinstance(a, dict):
            return all(same(a[k], b[k]) for k in a)
        return torch.equal(a, b) and a.dtype == b.dtype

    seen = {"checks": 0}

    def checked_train(base, trainable, masks, batch):
        st = t.async_state
        before = dict(lora=snap(t.global_lora), head=snap(t.global_head),
                      pending=snap(st["pending"]),
                      buffer=[snap(u.adapter) for u in st["buffer"]])
        out = local(base, trainable, masks, batch)
        assert same(before["lora"], t.global_lora)
        assert same(before["head"], t.global_head)
        assert same(before["pending"], st["pending"])
        assert all(same(b, u.adapter)
                   for b, u in zip(before["buffer"], st["buffer"]))
        def ptrs(tree):
            return [ad[leaf].untyped_storage().data_ptr()
                    for ad in tree.values() for leaf in ("A", "B")]
        pending = [p for tree in st["pending"].values() for p in ptrs(tree)]
        assert len(set(pending)) == len(pending)
        assert not set(pending) & set(ptrs(t.global_lora))
        seen["checks"] += 1
        return out

    hist = t_sched.BufferedAsync(speeds=SPEEDS, buffer_size=3).run(
        t, checked_train, data, 7)
    assert seen["checks"] == 7 and hist["flush_events"] == [3, 3, 1]


# ---------------------------------------------------------------------------
# SemiSync
# ---------------------------------------------------------------------------

def test_semisync_infinite_deadline_is_sync_round_bitwise(weights):
    """``SemiSync(deadline=inf)`` through ``run_experiment`` is the port's
    ``SyncRound``: every history column and the final global adapter and
    head, bit for bit."""
    runs = {}
    for name, rec in (("sync", _recording(t_sched.SyncRound)),
                      ("semi", _recording(t_sched.SemiSync, speeds=SPEEDS,
                                          deadline=float("inf")))):
        hist = t_sim.run_experiment(
            weights["tcfg"], t_sim.SimConfig(**SIM),
            t_session.ServerConfig(**SERVER), base_params=weights["tparams"],
            scheduler=rec, device="cpu")
        runs[name] = (rec.session, hist)
    (ss, sh), (ms, mh) = runs["sync"], runs["semi"]
    for k in sh:
        assert mh[k] == sh[k], k
    assert mh["stragglers"] == [0] * SIM["rounds"]
    for t in ss.global_lora:
        for leaf in ("A", "B", "mask"):
            assert torch.equal(ms.global_lora[t][leaf],
                               ss.global_lora[t][leaf]), (t, leaf)
    for k in ss.global_head:
        assert torch.equal(ms.global_head[k], ss.global_head[k])


def _semisync_pair(weights, setups, speeds, deadline):
    """A reference run of ``SemiSync(speeds, deadline)`` (3 rounds) and the
    port's anchored to it, both through the shared cohort trainers."""
    runs = {}
    for pkg, mod in (("reference", j_sched), ("port", t_sched)):
        j, t = _sessions(weights)
        sess = j if pkg == "reference" else t
        sched = _recording(
            mod.SemiSync, None,
            None if pkg == "reference" else runs["reference"][0].log,
            speeds=speeds, deadline=deadline)
        setup = setups[pkg]
        hist = sched.run(sess, setup["cohort_train"], setup["data_fn"],
                         SIM["rounds"], eval_fn=setup["eval_fn"])
        runs[pkg] = (sched, hist)
    (js, jh), (ts, th) = runs["reference"], runs["port"]
    for k in ("round", "stragglers", "round_time", "downlink_bytes",
              "uplink_bytes", "health"):
        assert th[k] == jh[k], k
    assert ts.log["cohorts"] == js.log["cohorts"]
    assert ts.log["collected"] == js.log["collected"]
    np.testing.assert_allclose(th["train_loss"], jh["train_loss"], **LOSS)
    np.testing.assert_allclose(th["eval_loss"], jh["eval_loss"], **LOSS)
    for i, (want, got) in enumerate(zip(js.log["merges"], ts.log["merges"])):
        _hold_merge(weights, want, got, f"semisync round {i}")
    t = ts.session
    assert t.metrics.counter("fed.stragglers").value == sum(th["stragglers"])
    h = t.metrics.histogram("fed.round_time_sim")
    assert (h.count, h.total) == (SIM["rounds"], sum(th["round_time"]))
    return th, ts.log


def test_semisync_deadline_matches_reference(weights, setups):
    """Two chronic stragglers (speed 0.1) against a deadline of 1: the
    reference's cohorts, survivors, stragglers, round times and bytes
    exactly, its losses and merges within the module's limits; the
    survivors and round times recomputed from the speeds."""
    speeds = np.array([4.0] * 4 + [0.1, 0.1])
    hist, log = _semisync_pair(weights, setups, speeds, 1.0)
    assert sum(hist["stragglers"]) > 0
    for cohort, kept, n_cut, rt in zip(log["cohorts"], log["collected"],
                                       hist["stragglers"],
                                       hist["round_time"]):
        dur = 1.0 / speeds[cohort]
        assert kept == [c for c, d in zip(cohort, dur) if d <= 1.0]
        assert n_cut == len(cohort) - len(kept)
        assert rt == (dur.max() if n_cut == 0 else 1.0)


def test_semisync_force_keeps_the_fastest(weights, setups):
    """A deadline nobody beats keeps the cohort's fastest client alone,
    and the round closes when it is in (after the deadline), as in the
    reference."""
    hist, log = _semisync_pair(weights, setups, SPEEDS, 1e-3)
    for cohort, kept, rt in zip(log["cohorts"], log["collected"],
                                hist["round_time"]):
        fastest = cohort[int(np.argmax(SPEEDS[cohort]))]
        assert kept == [fastest]
        assert rt == 1.0 / SPEEDS[fastest]
    assert hist["stragglers"] == [SERVER["clients_per_round"] - 1] * \
        SIM["rounds"]


def test_semisync_through_run_experiment_matches_reference(weights):
    """``run_experiment(scheduler=SemiSync(...))`` with the quantile
    deadline (the 0.5 quantile of 1 / SPEEDS): the same integers as the
    reference's, round 0's loss within ``LOSS``."""
    hists, scheds = {}, {}
    for pkg, mod_sched, mod_sim, mod_sess in (
            ("reference", j_sched, j_sim, j_session),
            ("port", t_sched, t_sim, t_session)):
        sched = _recording(mod_sched.SemiSync,
                           _initial_lora(weights, SERVER)
                           if pkg == "port" else None,
                           speeds=SPEEDS, deadline_quantile=0.5)
        kw = dict(engine=j_engine.AggregationEngine(use_pallas=False)) \
            if pkg == "reference" else dict(device="cpu")
        hists[pkg] = mod_sim.run_experiment(
            weights["jcfg" if pkg == "reference" else "tcfg"],
            mod_sim.SimConfig(**SIM), mod_sess.ServerConfig(**SERVER),
            base_params=weights["jparams" if pkg == "reference"
                                else "tparams"], scheduler=sched, **kw)
        scheds[pkg] = sched
    jh, th = hists["reference"], hists["port"]
    assert scheds["port"].resolved_deadline() == \
        scheds["reference"].resolved_deadline() == float(
            np.quantile(1.0 / SPEEDS, 0.5))
    for k in ("round", "stragglers", "round_time", "downlink_bytes",
              "uplink_bytes", "health"):
        assert th[k] == jh[k], k
    assert scheds["port"].log["collected"] == \
        scheds["reference"].log["collected"]
    np.testing.assert_allclose(th["train_loss"][0], jh["train_loss"][0],
                               **LOSS)


# ---------------------------------------------------------------------------
# mid-flight checkpoints
# ---------------------------------------------------------------------------

MIDFLIGHT = dict(speeds=np.array([2.0, 1.0, 0.5, 0.25, 0.3, 0.7]),
                 buffer_size=3, drain=False)


def _midflight(pkg, acfg=None):
    mod_sched, mod_sess = (j_sched, j_session) if pkg == "reference" \
        else (t_sched, t_session)
    return mod_sched.BufferedAsync(
        acfg=mod_sess.AsyncConfig(max_staleness=50), **MIDFLIGHT)


def test_buffered_async_midflight_resume_bitwise(weights, setups, tmp_path):
    """4 events → ``save`` → ``FedSession.restore`` → 3 events equals 7
    straight events bit for bit (``drain=False``, buffer 3, ``stateless``
    batches): the heap, the staleness log, the comm logs, the buffer's
    bytes, the global factors and the head."""
    local = setups["port"]["local_train"]
    _, full = _sessions(weights, engines=False)
    data = setups["data"]()
    _midflight("port").run(full, local, data, 7)
    _, a = _sessions(weights, engines=False)
    data = setups["data"]()
    _midflight("port").run(a, local, data, 4)
    assert a.version == 3 and len(a.async_state["buffer"]) == 1
    ckpt = str(tmp_path / "async")
    a.save(ckpt)
    b = t_session.FedSession.restore(
        ckpt, weights["tcfg"], t_session.ServerConfig(**SERVER),
        weights["tparams"], client_sizes=SIZES, device="cpu")
    st = b.async_state
    assert st["heap"] == a.async_state["heap"]
    assert all(type(x) is float and type(c) is int and type(v) is int
               for x, c, v in st["heap"])
    assert sorted(st["pending"]) == list(range(SERVER["num_clients"]))
    assert st["buffer"][0].to_bytes() == a.async_state["buffer"][0].to_bytes()
    _midflight("port").run(b, local, data, 3)
    assert b.version == full.version == 6
    assert b.staleness_log == full.staleness_log
    assert b.async_state["heap"] == full.async_state["heap"]
    assert [u.to_bytes() for u in b.async_state["buffer"]] == \
        [u.to_bytes() for u in full.async_state["buffer"]]
    assert b.comm_log == full.comm_log
    for t in full.global_lora:
        for leaf in ("A", "B", "mask"):
            assert torch.equal(b.global_lora[t][leaf],
                               full.global_lora[t][leaf]), (t, leaf)
    for k in full.global_head:
        assert torch.equal(b.global_head[k], full.global_head[k])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_midflight_checkpoint_restores_across_packages(weights, setups,
                                                       tmp_path, writer):
    """``writer`` runs 4 events and saves mid-flight; the other package
    restores it with the heap, the pending adapters and the buffer's bytes
    equal, and both go on for 3 events with the same events, staleness,
    flags and bytes."""
    j, t = _sessions(weights, engines=False)
    src, dst = (j, t) if writer == "reference" else (t, j)
    setup = setups[writer]
    data = setups["data"]()
    _midflight(writer).run(src, setup["local_train"], data, 4)
    ckpt = str(tmp_path / "async")
    src.save(ckpt)
    if writer == "reference":
        back = t_session.FedSession.restore(
            ckpt, weights["tcfg"], t_session.ServerConfig(**SERVER),
            weights["tparams"], client_sizes=SIZES, device="cpu")
    else:
        back = j_session.FedSession.restore(
            ckpt, weights["jcfg"], j_session.ServerConfig(**SERVER),
            weights["jparams"], client_sizes=SIZES)
    want, got = src.async_state, back.async_state
    assert got["heap"] == want["heap"]
    assert sorted(got["pending"]) == sorted(want["pending"])
    for cid, tree in want["pending"].items():
        w, g = _numpy(tree), _numpy(got["pending"][cid])
        for tt in w:
            for leaf in ("A", "B", "mask"):
                np.testing.assert_array_equal(g[tt][leaf], w[tt][leaf])
    assert [u.to_bytes() for u in got["buffer"]] == \
        [u.to_bytes() for u in want["buffer"]]
    assert back.version == src.version and \
        back.staleness_log == src.staleness_log
    reader = "port" if writer == "reference" else "reference"
    hists = {}
    for pkg, sess in ((writer, src), (reader, back)):
        hists[pkg] = _midflight(pkg).run(sess, setups[pkg]["local_train"],
                                         _resumed_data(setups, 4), 3)
    for k in ("time", "staleness", "accepted", "flush_events",
              "downlink_bytes", "uplink_bytes"):
        assert hists["port"][k] == hists["reference"][k], k


def _resumed_data(setups, done):
    """``stateless`` batches as they stand after ``done`` events of the
    MIDFLIGHT speeds (each client's call count replayed)."""
    data = setups["data"]()
    heap = [(1.0 / s, cid) for cid, s in enumerate(MIDFLIGHT["speeds"])]
    heapq.heapify(heap)
    for _ in range(done):
        t_now, cid = heapq.heappop(heap)
        data(cid)
        heapq.heappush(heap, (t_now + 1.0 / MIDFLIGHT["speeds"][cid], cid))
    return data


# ---------------------------------------------------------------------------
# the deprecated shims
# ---------------------------------------------------------------------------

def test_fedserver_shim_warns_and_matches_session(weights):
    scfg = t_session.ServerConfig(num_clients=4, clients_per_round=2,
                                  strategy="hlora", rank_policy="random",
                                  r_min=2, r_max=8, seed=0)
    with pytest.warns(DeprecationWarning,
                      match="FedSession with a SyncRound") as caught:
        srv = t_server.FedServer(weights["tcfg"], scfg, weights["tparams"],
                                 client_sizes=[32] * 4, device="cpu")
    assert len(caught) == 1
    sess = t_session.FedSession(weights["tcfg"], scfg, weights["tparams"],
                                client_sizes=[32] * 4, device="cpu")
    np.testing.assert_array_equal(srv.sample_cohort(), sess.sample_cohort())
    cohort = np.array([0, 2])
    stacked = sess.redistribute(cohort)
    legacy = srv.cohort_adapters(cohort)
    gen = torch.Generator().manual_seed(5)
    for t in stacked:
        for leaf in ("A", "B", "mask"):
            assert torch.equal(legacy[t][leaf], stacked[t][leaf])
        b = torch.randn(stacked[t]["B"].shape, generator=gen) \
            * stacked[t]["mask"][..., :, None]
        stacked[t] = dict(stacked[t], B=b)
        legacy[t] = dict(legacy[t], B=b)
    srv.update_global(legacy, cohort)
    sess.aggregate_round(stacked, cohort)
    for t in sess.global_lora:
        for leaf in ("A", "B", "mask"):
            assert torch.equal(srv.global_lora[t][leaf],
                               sess.global_lora[t][leaf]), (t, leaf)


def test_async_fedserver_shim_warns_and_matches_flush(weights):
    scfg = t_session.ServerConfig(num_clients=2, clients_per_round=2,
                                  strategy="naive", rank_policy="uniform",
                                  seed=0)
    with pytest.warns(DeprecationWarning, match="BufferedAsync") as caught:
        srv = t_async_server.AsyncFedServer(
            weights["tcfg"], scfg, t_session.AsyncConfig(),
            weights["tparams"], [1.0, 1.0], client_sizes=[32, 32],
            device="cpu")
    assert len(caught) == 1
    np.testing.assert_array_equal(srv.sizes, srv.client_sizes)
    sess = t_session.FedSession(weights["tcfg"], scfg, weights["tparams"],
                                client_sizes=[32, 32],
                                acfg=t_session.AsyncConfig(), device="cpu")
    ad, ver = srv.adapter_for(0)
    gen = torch.Generator().manual_seed(8)
    trained = {t: dict(a, B=torch.randn(a["B"].shape, generator=gen)
                       * a["mask"][..., :, None]) for t, a in ad.items()}
    assert srv.submit(0, trained, ver) is True
    flags = sess.flush_async([types.SimpleNamespace(
        client_id=0, start_version=ver, num_examples=32, adapter=trained,
        head=None)])
    assert flags == [True]
    assert srv.version == sess.version == 1
    for t in sess.global_lora:
        for leaf in ("A", "B", "mask"):
            assert torch.equal(srv.global_lora[t][leaf],
                               sess.global_lora[t][leaf]), (t, leaf)
    srv.acfg = t_session.AsyncConfig(max_staleness=1)
    srv.version = 5                               # simulate progress
    assert srv.submit(0, ad, ver) is False        # τ = 5 > 1: dropped
    assert srv.staleness_log[-1] == 5 and srv.version == 5


def test_simulate_async_rounds_is_buffered_async_of_one(weights, setups):
    """``simulate_async_rounds`` (with ``frozen=None``) is a buffer-of-one
    ``BufferedAsync`` under the server's own ``acfg``, bit for bit, and
    matches the reference's shim on the same events."""
    acfg = t_session.AsyncConfig(max_staleness=3)
    scfg = t_session.ServerConfig(**SERVER)
    with pytest.warns(DeprecationWarning):
        srv = t_async_server.AsyncFedServer(
            weights["tcfg"], scfg, acfg, weights["tparams"], SPEEDS,
            client_sizes=SIZES, device="cpu")
    local = setups["port"]["local_train"]
    h1 = t_async_server.simulate_async_rounds(srv, local, None,
                                              setups["data"](), 5)
    sess = t_session.FedSession(weights["tcfg"], scfg, weights["tparams"],
                                client_sizes=SIZES, acfg=acfg, device="cpu")
    h2 = t_sched.BufferedAsync(speeds=SPEEDS, buffer_size=1).run(
        sess, local, setups["data"](), 5)
    assert h1 == h2 and h1["flush_events"] == [1] * 5
    for t in sess.global_lora:
        for leaf in ("A", "B", "mask"):
            assert torch.equal(srv.global_lora[t][leaf],
                               sess.global_lora[t][leaf]), (t, leaf)
    with pytest.warns(DeprecationWarning):
        jsrv = j_async_server.AsyncFedServer(
            weights["jcfg"], j_session.ServerConfig(**SERVER),
            j_session.AsyncConfig(max_staleness=3), weights["jparams"],
            SPEEDS, client_sizes=SIZES)
    jh = j_async_server.simulate_async_rounds(
        jsrv, setups["reference"]["local_train"], None, setups["data"](), 5)
    for k in ("time", "staleness", "accepted", "downlink_bytes",
              "uplink_bytes"):
        assert h1[k] == jh[k], k


def test_shims_refuse_a_missing_gpu_without_device_cpu(weights):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately means it")
    scfg = t_session.ServerConfig(**SERVER)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_server.FedServer(weights["tcfg"], scfg, weights["tparams"],
                               client_sizes=SIZES)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_async_server.AsyncFedServer(
                weights["tcfg"], scfg, t_session.AsyncConfig(),
                weights["tparams"], SPEEDS)
