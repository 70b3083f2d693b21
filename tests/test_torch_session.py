"""The port's synchronous federated round against the reference's, on the
CPU: ``run_experiment`` → ``FedSession`` + ``SyncRound`` on
roberta-reduced (2 layers, d_model 128, LoRA on q and v at r_max 8), both
sides from the reference's own weights (``interop.params_from_jax``) and
the reference session's initial global adapter (``interop.lora_from_jax``;
the port draws its own from a ``torch.Generator``).

Two port runs are held to each reference run:

- **free**: the port runs on its own. Every integer of the run must be
  identical: cohorts, per-target ranks, ``target_ranks``, ranks after
  spectrum adaptation, every byte column and every health row. Floats are
  held in round 0 only, where both sides start from the same state. From
  round 1 on the reference's own result depends on directions with σ ≈ 0:
  when no client of a cohort holds rank r_max, ΔW' has fewer than r_max
  directions above float32 noise, the SVD's basis for the rest is
  arbitrary (any two SVD implementations choose differently), and the next
  cohort's high-rank clients train on those directions. Measured on this
  configuration: the effective global update parts by 0.13-0.26 of its
  norm under ``exact`` in round 1.
- **anchored**: before each broadcast the port session's global adapter
  and head are set to the reference's after the previous round, so each
  round starts from the same state. Every round's floats are then held.

Tolerances, float32 throughout:
- ``train_loss`` and ``eval_loss``: rtol 1e-4, atol 1e-5 (the same
  products summed in another order through two layers and two Adam steps;
  ``tests/test_torch_train.py``'s forward tolerance);
- ``eval_acc``: equal, except on examples whose reference logit margin
  |l_1 - l_0| is below ``MARGIN`` = 1e-3, where float32 reordering (~1e-5
  here) may flip the argmax; such examples are counted and bound the
  difference;
- the effective global update (alpha / r_max) A B, normwise 1e-4 of the
  reference's, and ``last_spectrum`` rtol 1e-4 with a floor of 1e-6 of
  σ_1: ``tests/test_torch_aggregate.py``'s tolerances for the slice as a
  whole (both sides run the Gram path, or a dense SVD under ``exact``);
- the randomized method draws its test matrix from a ``torch.Generator``,
  not the reference's key: its cohorts must equal the reference's in every
  round (the session's rng stream stays aligned), and its spectrum and
  global update are held against a float64 SVD of ΔW' built from the
  collected factors: spectra to 1e-4 of σ_1, and Eckart-Young
  | ||ΔW' - eff||_F - sqrt(Σ_{i>r} σ_i²) | to 1e-4 of ||ΔW'||_F, inside
  ``svd_randomized``'s contract (rank ΔW' ≤ r_max + oversample).
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core import agg_engine as j_engine
from repro.data import dirichlet_partition, make_pair_classification
from repro.fed import schedulers as j_sched
from repro.fed import session as j_session
from repro.fed import simulation as j_sim
from repro.models import model as j_model
from repro.models import transformer as j_tf
from repro_torch import interop
from repro_torch.configs import get_reduced
from repro_torch.fed import schedulers as t_sched
from repro_torch.fed import session as t_session
from repro_torch.fed import simulation as t_sim
from repro_torch.obs import Recorder

LOSS = dict(rtol=1e-4, atol=1e-5)
UPDATE_REL = 1e-4
SPEC_RTOL = 1e-4
MARGIN = 1e-3
SIM = dict(num_examples=256, eval_examples=128, rounds=3, local_steps=2,
           local_batch=8, lr=1e-3)
SERVER = dict(num_clients=6, clients_per_round=3, seed=0)
CONFIGS = {
    "naive": dict(strategy="naive"),
    "hlora-factored": dict(strategy="hlora"),
    "hlora-exact": dict(strategy="hlora", svd_method="exact"),
    "flora": dict(strategy="flora"),
    "spectrum-per-target": dict(strategy="hlora", rank_policy="spectrum",
                                per_target_ranks=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread avoids thread-pool
    overhead and contention with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = j_get_reduced("roberta-large"), get_reduced("roberta-large")
    jparams = j_model.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _recording(base, initial=None, anchors=None):
    """A ``SyncRound`` of package ``base`` that logs, for every round, the
    cohort and its per-target ranks at sampling, and after the merge the
    global adapter and head, the spectrum, the ranks and ``target_ranks``.
    ``initial``: the global adapter to start from (the port's session gets
    the reference's); ``anchors``: the reference's log, whose state after
    round i is put in place before round i + 1's broadcast."""

    class Recording(base):
        def run(self, session, train, data_fn, num_rounds, eval_fn=None,
                eval_every=1):
            self.log = []
            if initial is not None:
                session.global_lora = interop.lora_from_jax(initial, "cpu")
            sample, broadcast, merge = (session.sample_cohort,
                                        session.broadcast_cohort,
                                        session.aggregate_round)

            def sample_logged():
                cohort = sample()
                self.log.append({
                    "cohort": [int(c) for c in cohort],
                    "ranks": [session._client_ranks(int(c))
                              for c in cohort]})
                return cohort

            def broadcast_anchored(cohort):
                done = session.rounds_done
                if anchors is not None and done > 0:
                    prev = anchors[done - 1]
                    session.global_lora = interop.lora_from_jax(
                        prev["lora"], "cpu")
                    session.global_head = interop.tree_from_numpy(
                        prev["head"], "cpu")
                return broadcast(cohort)

            def merge_logged(tree, cohort, **kw):
                merge(tree, cohort, **kw)
                spec = session.last_spectrum
                self.log[-1].update(
                    lora=_numpy(session.global_lora),
                    head=_numpy(session.global_head),
                    spectrum=None if spec is None else _numpy(spec),
                    collected=_numpy(tree),
                    post_ranks=[int(r) for r in session.ranks],
                    target_ranks=session.target_ranks)

            session.sample_cohort = sample_logged
            session.broadcast_cohort = broadcast_anchored
            session.aggregate_round = merge_logged
            return super().run(session, train, data_fn, num_rounds,
                               eval_fn, eval_every)

    return Recording()


def _reference(weights, server, sim=SIM):
    sched = _recording(j_sched.SyncRound)
    hist = j_sim.run_experiment(
        weights["jcfg"], j_sim.SimConfig(**sim),
        j_session.ServerConfig(**server), base_params=weights["jparams"],
        engine=j_engine.AggregationEngine(use_pallas=False), scheduler=sched)
    return hist, sched.log


def _initial_lora(weights, server):
    """The reference session's initial global adapter (numpy)."""
    return jax.tree.map(np.asarray, j_tf.init_lora(
        jax.random.PRNGKey(server["seed"]), weights["jcfg"]))


def _port(weights, server, anchors=None, sim=SIM):
    sched = _recording(t_sched.SyncRound, _initial_lora(weights, server),
                       anchors)
    hist = t_sim.run_experiment(
        weights["tcfg"], t_sim.SimConfig(**sim),
        t_session.ServerConfig(**server), base_params=weights["tparams"],
        scheduler=sched, device="cpu")
    return hist, sched.log


def _effective(lora, alpha, r_max):
    return {t: (alpha / r_max) * (ad["A"].astype(np.float64)
                                  @ ad["B"].astype(np.float64))
            for t, ad in lora.items()}


def _normwise(got, want, rel, what):
    num = np.linalg.norm(got - want, axis=(-2, -1))
    den = np.maximum(np.linalg.norm(want, axis=(-2, -1)), 1e-30)
    assert (num / den).max() <= rel, (what, (num / den).max())


def _spectrum_close(got, want, what):
    for t in want:
        floor = 1e-6 * max(np.abs(want[t]).max(), 1e-30)
        np.testing.assert_allclose(got[t], want[t], rtol=SPEC_RTOL,
                                   atol=floor, err_msg=f"{what} {t}")


def _hold_integers(jhist, jlog, thist, tlog):
    assert thist["round"] == jhist["round"]
    assert thist["downlink_bytes"] == jhist["downlink_bytes"]
    assert thist["uplink_bytes"] == jhist["uplink_bytes"]
    assert thist["health"] == jhist["health"]
    for i, (want, got) in enumerate(zip(jlog, tlog)):
        assert got["cohort"] == want["cohort"], i
        assert got["ranks"] == want["ranks"], i
        assert got["post_ranks"] == want["post_ranks"], i
        assert got["target_ranks"] == want["target_ranks"], i


def _hold_round(weights, jrec, trec, what):
    """One round's merge: the effective global update and the spectrum."""
    cfg = weights["tcfg"]
    want = _effective(jrec["lora"], cfg.lora.alpha, cfg.lora.r_max)
    got = _effective(trec["lora"], cfg.lora.alpha, cfg.lora.r_max)
    for t in want:
        _normwise(got[t], want[t], UPDATE_REL, f"{what} {t}")
    assert (jrec["spectrum"] is None) == (trec["spectrum"] is None), what
    if jrec["spectrum"] is not None:
        _spectrum_close(trec["spectrum"], jrec["spectrum"], what)
    for k, v in jrec["head"].items():
        np.testing.assert_allclose(trec["head"][k], v, **LOSS,
                                   err_msg=f"{what} head {k}")


@functools.partial(jax.jit, static_argnames=("cfg",))
def _j_logits(params, tokens, cfg):
    return j_model.forward(params, {"tokens": tokens}, cfg, remat=False)[0]


def _eval_margins(weights, rec, sim):
    """The reference's logit margin |l_1 - l_0| of every eval example
    under its global adapter and head after a round."""
    cfg = weights["jcfg"]
    tokens, _ = make_pair_classification(
        "mrpc", sim["eval_examples"], seed=10_000, vocab_size=cfg.vocab_size)
    params = {k: v for k, v in weights["jparams"].items()
              if k not in ("lora", "cls_head", "cls_bias")}
    params.update({k: jnp.asarray(v) for k, v in rec["head"].items()})
    params["lora"] = jax.tree.map(jnp.asarray, rec["lora"])
    logits = np.asarray(_j_logits(params, jnp.asarray(tokens), cfg))
    return np.abs(logits[:, 1] - logits[:, 0])


def _hold_eval(weights, jhist, jlog, thist, rounds, sim=SIM):
    n = sim["eval_examples"]
    for i in rounds:
        np.testing.assert_allclose(thist["eval_loss"][i],
                                   jhist["eval_loss"][i], **LOSS)
        near = int((_eval_margins(weights, jlog[i], sim) < MARGIN).sum())
        flipped = round(abs(thist["eval_acc"][i] - jhist["eval_acc"][i]) * n)
        assert flipped <= near, (i, flipped, near)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_experiment_matches_reference(weights, name):
    server = dict(SERVER, **CONFIGS[name])
    jhist, jlog = _reference(weights, server)
    thist, tlog = _port(weights, server)
    _hold_integers(jhist, jlog, thist, tlog)
    # free run: floats in round 0, where both sides start alike
    np.testing.assert_allclose(thist["train_loss"][0], jhist["train_loss"][0],
                               **LOSS)
    _hold_round(weights, jlog[0], tlog[0], f"{name} free round 0")
    _hold_eval(weights, jhist, jlog, thist, [0])
    # anchored run: every round from the reference's state
    ahist, alog = _port(weights, server, anchors=jlog)
    _hold_integers(jhist, jlog, ahist, alog)
    np.testing.assert_allclose(ahist["train_loss"], jhist["train_loss"],
                               **LOSS)
    for i in range(len(jlog)):
        _hold_round(weights, jlog[i], alog[i], f"{name} anchored round {i}")
    _hold_eval(weights, jhist, jlog, ahist, range(len(jlog)))


def _float64_svd(collected, eta, alpha):
    """ΔW' = Σ_k η̂_k (alpha / r_k) (A_k m_k)(B_k m_k) of each item in
    float64 from a collected cohort tree, and its singular values."""
    out = {}
    for t, ad in collected.items():
        m = ad["mask"].astype(np.float64)               # (K, L, r)
        coef = eta[:, None] / eta.sum() * alpha / np.maximum(
            m.sum(-1), 1.0)                              # (K, L)
        a = ad["A"] * m[..., None, :] * coef[..., None, None]
        b = ad["B"] * m[..., :, None]
        dw = np.einsum("klir,klro->lio", a, b)
        out[t] = (dw, np.linalg.svd(dw, compute_uv=False))
    return out


def test_randomized_keeps_the_rng_stream_and_its_contract(weights):
    """Round 0's cohort has ranks summing to at most r_max + oversample
    (8 + 8), so its ΔW' is inside ``svd_randomized``'s contract; later
    rounds check the cohorts alone (the rng stream)."""
    server = dict(SERVER, strategy="hlora", svd_method="randomized")
    jhist, jlog = _reference(weights, server)
    thist, tlog = _port(weights, server)
    _hold_integers(jhist, jlog, thist, tlog)
    cfg = weights["tcfg"]
    alpha, r_max = cfg.lora.alpha, cfg.lora.r_max
    rec = tlog[0]
    assert sum(r["q"] for r in rec["ranks"]) <= r_max + 8
    sizes = np.asarray([len(s) for s in dirichlet_partition(
        make_pair_classification(
            "mrpc", SIM["num_examples"], seed=0,
            vocab_size=cfg.vocab_size)[1], SERVER["num_clients"], 0.5,
        seed=0)], np.float64)
    eta = sizes[rec["cohort"]]
    truth = _float64_svd(rec["collected"], eta, alpha)
    eff = _effective(rec["lora"], alpha, r_max)
    for t, (dw, sig) in truth.items():
        s = rec["spectrum"][t].astype(np.float64)
        assert np.abs(s - sig[:, :r_max]).max() <= SPEC_RTOL * sig[:, 0].min()
        tail = np.sqrt((sig[:, r_max:] ** 2).sum(-1))
        dist = np.linalg.norm(dw - eff[t], axis=(-2, -1))
        norm = np.linalg.norm(dw, axis=(-2, -1))
        assert (np.abs(dist - tail) / norm).max() <= 1e-4, t
    # and the exact method on the same collected tree agrees with it
    from repro_torch.core.agg_engine import AggregationEngine
    tree = interop.tree_from_numpy(rec["collected"], "cpu")
    full = {t: torch.ones_like(ad["mask"][:1]) for t, ad in tree.items()}
    _, spec = AggregationEngine()(tree, torch.tensor(eta, dtype=torch.float32),
                                  alpha, method="exact", new_masks=full)
    _spectrum_close(rec["spectrum"], _numpy(spec), "randomized vs exact")


def test_run_centralized_matches_reference(weights):
    sim = dict(SIM, rounds=2)
    base = dict(weights["jparams"])
    jhist = j_sim.run_centralized(weights["jcfg"], j_sim.SimConfig(**sim),
                                  rank=4, base_params=base)
    thist = t_sim.run_centralized(weights["tcfg"], t_sim.SimConfig(**sim),
                                  rank=4, base_params=weights["tparams"],
                                  device="cpu")
    assert thist["round"] == jhist["round"]
    np.testing.assert_allclose(thist["train_loss"], jhist["train_loss"],
                               **LOSS)
    np.testing.assert_allclose(thist["eval_loss"], jhist["eval_loss"],
                               **LOSS)
    assert t_sim.rounds_to_target(thist, 0.0) == 0
    assert t_sim.rounds_to_target(thist, 2.0) is None


def _session(weights, **kw):
    return t_session.FedSession(weights["tcfg"], t_session.ServerConfig(
        **dict(SERVER, **kw.pop("server", {}))), weights["tparams"],
        device="cpu", **kw)


@pytest.mark.parametrize("policy", ["uniform", "random", "capacity", "data",
                                    "spectrum"])
def test_session_ranks_and_rng_draws_match_reference(weights, policy):
    """``assign_ranks`` under each policy through the session (capacity
    draws its capacities from the session rng), then the same cohorts and
    aggregation draws from the stream."""
    server = dict(SERVER, rank_policy=policy)
    sizes = [40, 3, 77, 12, 9, 120]
    j = j_session.FedSession(weights["jcfg"], j_session.ServerConfig(
        **server), weights["jparams"], client_sizes=sizes)
    t = _session(weights, server=server, client_sizes=sizes)
    np.testing.assert_array_equal(t.ranks, j.ranks)
    assert t.ranks.dtype == j.ranks.dtype
    for _ in range(3):
        cohort = j.sample_cohort()
        np.testing.assert_array_equal(t.sample_cohort(), cohort)
        np.testing.assert_array_equal(t.cohort_weights(cohort).numpy(),
                                      np.asarray(j.cohort_weights(cohort)))
        assert int(t.rng.integers(2 ** 31)) == int(j.rng.integers(2 ** 31))


@pytest.mark.parametrize("strategy", ["naive", "hlora", "flora"])
def test_redistribute_and_wire_round_trip_match_reference(weights, strategy):
    """From one global adapter (trained-looking B, a per-target cap on v):
    the redistributed stack, the broadcast bytes and the collected stack
    equal the reference's, and the wire round trip is exact."""
    server = dict(SERVER, strategy=strategy)
    j = j_session.FedSession(weights["jcfg"], j_session.ServerConfig(
        **server), weights["jparams"])
    t = _session(weights, server=server)
    rng = np.random.default_rng(5)
    lora = _initial_lora(weights, SERVER)
    for ad in lora.values():
        ad["B"] = (0.05 * rng.standard_normal(ad["B"].shape)).astype(
            np.float32)
    j.global_lora = jax.tree.map(jnp.asarray, lora)
    t.global_lora = interop.lora_from_jax(lora, "cpu")
    j.target_ranks = t.target_ranks = {"q": 8, "v": 3}
    cohort = np.array([0, 3, 5])
    want = _numpy(j.redistribute(cohort))
    got = _numpy(t.redistribute(cohort))
    for tt in want:
        for leaf in ("A", "B", "mask"):
            np.testing.assert_array_equal(got[tt][leaf], want[tt][leaf])
    for i, cid in enumerate(cohort):
        sl_j = {tt: {"A": ad["A"][i], "B": ad["B"][i]}
                for tt, ad in j.redistribute(cohort).items()}
        sl_t = {tt: {"A": ad["A"][i], "B": ad["B"][i]}
                for tt, ad in t.redistribute(cohort).items()}
        assert t.make_broadcast(cid, sl_t).to_bytes() == \
            j.make_broadcast(cid, sl_j).to_bytes()
    jtree, jheads = j.broadcast_cohort(cohort)
    ttree, theads = t.broadcast_cohort(cohort)
    for tt in want:
        for leaf in ("A", "B", "mask"):
            np.testing.assert_array_equal(_numpy(ttree)[tt][leaf],
                                          np.asarray(jtree[tt][leaf]))
    assert t.comm_log == j.comm_log
    jc, jh = j.collect_updates(cohort, jtree, jheads)
    tc, th = t.collect_updates(cohort, ttree, theads)
    for tt in want:
        for leaf in ("A", "B", "mask"):
            np.testing.assert_array_equal(_numpy(tc)[tt][leaf],
                                          np.asarray(jc[tt][leaf]))
            assert torch.equal(tc[tt][leaf], ttree[tt][leaf])
    for k in jh:
        np.testing.assert_array_equal(th[k].numpy(), np.asarray(jh[k]))
    assert t.comm_log == j.comm_log
    assert t.comm_totals() == j.comm_totals()
    assert t.metrics.counter("fed.uplink_bytes").value == \
        sum(t.comm_log["uplink"])


def test_global_params_and_untracked_comm(weights):
    t = _session(weights, track_comm=False)
    params = t.global_params()
    assert params.lora is t.global_lora
    assert set(params.cls) == {"cls_head", "cls_bias"}
    assert params.embed is weights["tparams"].embed
    cohort = t.sample_cohort()
    tree, heads = t.broadcast_cohort(cohort)
    assert tree["q"]["A"].shape[0] == len(cohort)
    assert heads["cls_head"].shape[0] == len(cohort)
    tc, th = t.collect_updates(cohort, tree, heads)
    assert tc is tree and th is heads
    assert t.comm_log == {"downlink": [0], "uplink": [0]}


class _Stub:
    """A stand-in for what the port does not take."""


@pytest.mark.parametrize("kw", ["acfg", "mesh", "population", "sampler",
                                "codec"])
def test_session_refuses_what_is_not_ported(weights, kw):
    """The mesh is not ported and raises. ``acfg`` (the async staleness
    policy) is taken and kept, and the session has no async state until a
    ``BufferedAsync`` run installs it. A population is taken (its sizes and
    ranks become the session's; one of another size raises ``ValueError``),
    a sampler needs one (``ValueError`` without), and a codec is taken by
    name or object, ``ServerConfig.codec`` when none is given."""
    from repro_torch.fed import compress, population
    if kw == "acfg":
        acfg = t_session.AsyncConfig(max_staleness=3, base_weight=0.5)
        sess = _session(weights, acfg=acfg)
        assert sess.acfg is acfg and sess.async_state is None
        assert _session(weights).acfg == t_session.AsyncConfig()
        return
    if kw == "mesh":
        with pytest.raises(NotImplementedError, match=kw):
            _session(weights, mesh=_Stub())
        return
    n = SERVER["num_clients"]
    pop = population.ClientPopulation.synthetic(n, seed=4)
    if kw == "population":
        sess = _session(weights, population=pop)
        np.testing.assert_array_equal(sess.client_sizes, pop.num_examples)
        np.testing.assert_array_equal(sess.ranks, pop.ranks)
        assert sess.sampler is None and pop.metrics is sess.metrics
        with pytest.raises(ValueError, match="num_clients"):
            _session(weights, population=population.ClientPopulation.
                     synthetic(n + 1, seed=4))
        return
    if kw == "sampler":
        sess = _session(weights, population=pop, sampler="uniform")
        assert isinstance(sess.sampler, population.UniformSampler)
        assert len(sess.sample_cohort()) == SERVER["clients_per_round"]
        with pytest.raises(ValueError, match="needs a population"):
            _session(weights, sampler="uniform")
        with pytest.raises(ValueError, match="needs a population"):
            _session(weights, sampler=population.RankStratifiedSampler())
        return
    assert _session(weights).codec is None
    assert _session(weights, codec="int8").codec.name == "int8"
    codec = compress.TopKCodec(2)
    assert _session(weights, codec=codec).codec is codec
    assert _session(weights, server=dict(codec="bf16")).codec.name == "bf16"
    with pytest.raises(ValueError, match="unknown wire codec"):
        _session(weights, codec="zip")


def test_session_records_its_phases_on_a_recorder(weights):
    """A recorder is taken: one cohort through broadcast, collect and
    aggregate records those three spans on ``fed.server``, in that order,
    and one wire sample a direction, equal to the comm log."""
    rec = Recorder()
    t = _session(weights, recorder=rec)
    cohort = t.sample_cohort()
    tree, heads = t.broadcast_cohort(cohort)
    tc, th = t.collect_updates(cohort, tree, heads)
    t.aggregate_round(tc, cohort, stacked_heads=th)
    spans = [(e[1], e[5]) for e in rec.events() if e[0] == "X"]
    assert spans == [("broadcast", {"cohort": 3}),
                     ("collect", {"cohort": 3}),
                     ("aggregate", {"cohort": 3, "round": 0})]
    assert all(e[2] == "fed.server" for e in rec.events() if e[0] == "X")
    wire = [(e[1], e[2], e[5]) for e in rec.events() if e[0] == "C"]
    assert wire == [
        ("fed.downlink_bytes", "fed.wire",
         {"fed.downlink_bytes": t.comm_log["downlink"][0]}),
        ("fed.uplink_bytes", "fed.wire",
         {"fed.uplink_bytes": t.comm_log["uplink"][0]})]


def test_round_refusals(weights):
    cfg, tparams = weights["tcfg"], weights["tparams"]
    scfg = t_session.ServerConfig(**SERVER)
    # BufferedAsync is ported: one round of 3 clients is 3 events, merged
    # two at a time and the last drained
    hist = t_sim.run_experiment(
        cfg, t_sim.SimConfig(**dict(SIM, rounds=1)), scfg,
        base_params=tparams, scheduler=t_sched.BufferedAsync(
            speeds=np.ones(SERVER["num_clients"]), buffer_size=2),
        device="cpu")
    assert hist["flush_events"] == [2, 1]
    assert all(b > 0 for b in hist["uplink_bytes"])
    with pytest.raises(ValueError, match="base params"):
        t_session.FedSession(cfg, scfg, copy.copy(tparams).to_device("meta"),
                             device="cpu")
