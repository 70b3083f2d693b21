"""The port's population-scale federation against the reference's, on the
CPU: ``LazyDirichlet`` and ``iid_partition``, ``ClientPopulation`` and the
samplers (``repro_torch/fed/population.py``), the session's population,
sampler and codec, ``EdgeAggregate`` and ``HierarchicalTopology``
(``repro_torch/fed/topology.py``) through ``SyncRound(topology=)``, and
``examples/fed_finetune_torch.py``'s ``run_population`` against
``examples/fed_finetune.py``'s, on roberta-reduced (2 layers, d_model 128,
LoRA on q and v at r_max 8) from the reference's weights and the reference
session's initial global adapter (``tests/test_torch_session.py``'s
fixtures).

Integers are held exactly: partitions, sizes, ranks, speeds, shards and
batches, cohorts, comm logs (edge rows included) and byte columns.
Floats: 'stack' mode is the port's own flat round bit for bit; 'engine'
mode under naive is held to the flat round at the reference test's
tolerance (dW' rtol 1e-4, atol 1e-5; heads rtol 1e-5, atol 1e-6); merges
against the reference's at ``tests/test_torch_session.py``'s limits. The
example's run is anchored as ``tests/test_torch_async.py`` anchors its
rounds: the port's session starts on the reference's adapter, is put back
on the reference's state before each broadcast, and its trained cohort is
held to the reference's (normwise ``TRAINED_REL``) and replaced by it, so
every int8 message is encoded from the same arrays and every byte is
equal, and each round's losses come from the same state.
"""
import argparse
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lora as j_lora
from repro.data import partition as j_part
from repro.fed import messages as j_msg
from repro.fed import population as j_pop
from repro.fed import schedulers as j_sched
from repro.fed import session as j_session
from repro.fed import simulation as j_sim
from repro.fed import topology as j_topo
from repro.obs import Recorder as JRecorder
from repro_torch import interop
from repro_torch.core.lora import delta_w
from repro_torch.data import (LazyDirichlet, dirichlet_partition,
                              iid_partition, make_pair_classification)
from repro_torch.fed import messages as t_msg
from repro_torch.fed import population as t_pop
from repro_torch.fed import schedulers as t_sched
from repro_torch.fed import session as t_session
from repro_torch.fed import simulation as t_sim
from repro_torch.fed import topology as t_topo
from repro_torch.obs import MetricsRegistry, Recorder
from test_torch_async import _hold_trained, _numpy_update
from test_torch_session import (LOSS, SERVER, SIM, UPDATE_REL,  # noqa: F401
                                _effective, _initial_lora, _normwise, _numpy,
                                _one_torch_thread, _spectrum_close, weights)

ROOT = Path(__file__).resolve().parents[1]
DW = dict(rtol=1e-4, atol=1e-5)
HEAD = dict(rtol=1e-5, atol=1e-6)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=str(what))


# ---------------------------------------------------------------------------
# partitions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,clients,classes,alpha,seed", [
    (400, 20, 4, 0.5, 3), (1000, 100, 2, 0.1, 0), (57, 9, 5, 2.0, 11)])
def test_lazy_dirichlet_equals_reference(n, clients, classes, alpha, seed):
    labels = np.random.default_rng(seed).integers(0, classes, size=n)
    want = j_part.LazyDirichlet(labels, clients, alpha, seed)
    got = LazyDirichlet(labels, clients, alpha, seed)
    _eq(got.sizes, want.sizes)
    assert got.sizes.dtype == want.sizes.dtype and got.num_clients == clients
    eager = dirichlet_partition(labels, clients, alpha, seed, min_size=0)
    for cid in range(clients):
        _eq(got.indices_for(cid), want.indices_for(cid), cid)
        _eq(got.indices_for(cid), eager[cid], cid)
        assert got.indices_for(cid).dtype == np.int64


@pytest.mark.parametrize("n,clients,seed", [(10, 3, 0), (1000, 7, 5),
                                            (5, 8, 2)])
def test_iid_partition_equals_reference(n, clients, seed):
    want, got = j_part.iid_partition(n, clients, seed), \
        iid_partition(n, clients, seed)
    assert len(got) == len(want) == clients
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(np.sort(np.concatenate(got)), np.arange(n))


# ---------------------------------------------------------------------------
# ClientPopulation
# ---------------------------------------------------------------------------

def test_synthetic_population_equals_reference():
    """10,000 clients: the metadata vectors, shards and a round's batches
    equal the reference's; round after round only the cohort is resident,
    counted by the registry."""
    n = 10_000
    want = j_pop.ClientPopulation.synthetic(n, task="rte", seed=3,
                                            vocab_size=512)
    reg = MetricsRegistry()
    got = t_pop.ClientPopulation.synthetic(n, task="rte", seed=3,
                                           vocab_size=512)
    got.metrics = reg
    assert got.size == n and got.materialized_total == 0
    for k in ("num_examples", "ranks", "speeds"):
        _eq(getattr(got, k), getattr(want, k), k)
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
    for cid in (0, 17, 9_999):
        for g, w in zip(got.materialize(cid), want.materialize(cid)):
            _eq(g, w, cid)
    assert got.resident() == 3
    got.release()
    want.release()
    assert got.resident() == 0 and reg.gauge(
        "fed.population.resident").value == 0
    for rnd, cohort in enumerate(([4, 17, 23, 9_000], [1, 2, 3, 5000],
                                  [17, 4, 8, 77])):
        d = got.round_data(np.asarray(cohort), rnd, 2, 4, device="cpu")
        w = want.round_data(np.asarray(cohort), rnd, 2, 4)
        for k in ("tokens", "labels"):
            assert d[k].dtype == torch.int32 and d[k].device.type == "cpu"
            _eq(d[k].numpy(), w[k], (rnd, k))
        assert got.resident() == 0
    assert got.max_resident == 4 == want.max_resident
    assert got.materialized_total == 3 + 12
    assert reg.counter("fed.population.materialized").value == 15
    fn = got.data_fn(1, 2, device="cpu")
    _eq(fn([5, 6], 9)["tokens"].numpy(),
        want.data_fn(1, 2)([5, 6], 9)["tokens"])


def test_population_from_partition_equals_reference():
    tokens, labels = make_pair_classification("mrpc", 300, seed=1,
                                              vocab_size=256)
    want = j_pop.ClientPopulation.from_partition(tokens, labels, 10,
                                                 alpha=0.5, seed=1)
    got = t_pop.ClientPopulation.from_partition(tokens, labels, 10,
                                                alpha=0.5, seed=1)
    _eq(got.num_examples, want.num_examples)
    _eq(got.ranks, want.ranks)
    assert got.speeds is None and want.speeds is None
    for cid in range(10):
        for g, w in zip(got.materialize(cid), want.materialize(cid)):
            _eq(g, w, cid)
    got.release()
    assert got.resident() == 0 and got.max_resident == 10


def test_population_round_data_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately means it")
    pop = t_pop.ClientPopulation.synthetic(5, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        pop.round_data([0, 1], 0, 1, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        pop.data_fn(1, 2)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

def _pops(n, seed, skew=False):
    """A metadata-only population of each package (``shard_fn`` raises:
    a sampler must never materialize a shard)."""
    def boom(cid):
        raise AssertionError("a sampler materialized a shard")
    rng = np.random.default_rng(seed)
    ranks = rng.choice([2, 3, 8], size=n, p=[0.9, 0.08, 0.02]) if skew \
        else rng.integers(2, 9, size=n)
    return (j_pop.ClientPopulation(boom, np.full(n, 64), ranks=ranks),
            t_pop.ClientPopulation(boom, np.full(n, 64), ranks=ranks))


@pytest.mark.parametrize("kind", ["uniform", "rank_stratified",
                                  "availability"])
@pytest.mark.parametrize("skew", [False, True])
def test_samplers_equal_reference(kind, skew):
    n = 200
    jp, tp = _pops(n, 7, skew)
    if kind == "availability":
        js = j_pop.AvailabilityTraceSampler.diurnal(n, period=6, duty=0.3,
                                                    seed=2)
        ts = t_pop.AvailabilityTraceSampler.diurnal(n, period=6, duty=0.3,
                                                    seed=2)
        _eq(ts.trace, js.trace)
    else:
        js, ts = j_pop.sampler_from_name(kind), t_pop.sampler_from_name(kind)
    assert ts.name == js.name
    for seed in (0, 42):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        for rnd in range(6):
            for k in (1, 3, 7, 10, 50, 400):
                want = js.sample(jp, jr, rnd, k)
                got = ts.sample(tp, tr, rnd, k)
                _eq(got, want, (seed, rnd, k))
                assert got.dtype == want.dtype
        assert tr.integers(2 ** 31) == jr.integers(2 ** 31)


def test_sampler_refusals_equal_reference():
    nor = t_pop.ClientPopulation(lambda c: None, np.full(8, 64))
    with pytest.raises(ValueError, match="ranks"):
        t_pop.RankStratifiedSampler().sample(nor, np.random.default_rng(0),
                                             0, 2)
    with pytest.raises(ValueError, match="bool"):
        t_pop.AvailabilityTraceSampler(np.zeros(3))
    dead = t_pop.AvailabilityTraceSampler(np.zeros((3, 2), bool))
    pop3 = t_pop.ClientPopulation(lambda c: None, np.full(3, 64))
    got = dead.sample(pop3, np.random.default_rng(0), 0, 2)
    want = j_pop.AvailabilityTraceSampler(np.zeros((3, 2), bool)).sample(
        j_pop.ClientPopulation(lambda c: None, np.full(3, 64)),
        np.random.default_rng(0), 0, 2)
    _eq(got, want)
    assert t_pop.sampler_from_name(None) is None
    assert t_pop.sampler_from_name(" None ") is None
    s = t_pop.UniformSampler()
    assert t_pop.sampler_from_name(s) is s
    with pytest.raises(ValueError, match="unknown sampler"):
        t_pop.sampler_from_name("power_of_choice")


# ---------------------------------------------------------------------------
# the session with a population
# ---------------------------------------------------------------------------

def test_session_cohorts_and_ranks_with_a_population_equal_reference(
        weights):
    """A session of each package over the same 10,000-client population
    and rank-stratified sampler: sizes, ranks, and five rounds' cohorts and
    per-client ranks equal; the port records a ``cohort_sampled`` instant a
    round while recording, as the reference does."""
    n = 10_000
    scfg = dict(SERVER, num_clients=n, clients_per_round=9)
    jp = j_pop.ClientPopulation.synthetic(n, seed=1)
    tp = t_pop.ClientPopulation.synthetic(n, seed=1)
    jrec, trec = JRecorder(), Recorder()
    j = j_session.FedSession(weights["jcfg"], j_session.ServerConfig(**scfg),
                             weights["jparams"], population=jp,
                             sampler="rank_stratified", recorder=jrec)
    t = t_session.FedSession(weights["tcfg"], t_session.ServerConfig(**scfg),
                             weights["tparams"], population=tp,
                             sampler="rank_stratified", recorder=trec,
                             device="cpu")
    _eq(t.client_sizes, j.client_sizes)
    _eq(t.ranks, j.ranks)
    assert t.ranks.dtype == j.ranks.dtype
    assert tp.metrics is t.metrics
    for rnd in range(5):
        want, got = j.sample_cohort(), t.sample_cohort()
        _eq(got, want, rnd)
        assert got.dtype == want.dtype
        assert set(t.ranks[got]) == set(range(2, 9))   # every bucket
        assert [t._client_ranks(int(c)) for c in got] == \
            [j._client_ranks(int(c)) for c in want]
        j.rounds_done += 1
        t.rounds_done += 1

    def shape(events):
        return [(e[0], e[1], e[2], e[5]) for e in events]
    assert shape(trec.events()) == shape(jrec.events())
    assert len(trec.events()) == 5


def test_ten_thousand_client_round_is_memory_bounded(weights):
    """A sampled SyncRound over a 10,000-client population materializes
    the cohort and nothing more."""
    n = 10_000
    pop = t_pop.ClientPopulation.synthetic(
        n, seed=0, vocab_size=weights["tcfg"].vocab_size)
    scfg = t_session.ServerConfig(num_clients=n, clients_per_round=4,
                                  seed=0, codec="int8")
    sess = t_session.FedSession(weights["tcfg"], scfg, weights["tparams"],
                                population=pop, sampler="rank_stratified",
                                device="cpu")
    from repro_torch.fed import make_cohort_train
    from repro_torch.optim import adamw
    train = make_cohort_train(weights["tcfg"], adamw(1e-3), device="cpu")
    h = t_sched.SyncRound().run(sess, train, pop.data_fn(1, 4, "cpu"), 2)
    assert np.isfinite(h["train_loss"]).all()
    assert all(b > 0 for b in h["downlink_bytes"] + h["uplink_bytes"])
    assert pop.materialized_total == 8 and pop.max_resident == 4
    assert pop.resident() == 0
    assert sess.metrics.counter("fed.population.materialized").value == 8


# ---------------------------------------------------------------------------
# EdgeAggregate and HierarchicalTopology
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", [None, "int8"])
def test_edge_aggregate_bytes_equal_reference(codec):
    from repro.fed import compress as j_compress
    from repro_torch.fed import compress as t_compress
    rng = np.random.default_rng(2)
    jups, tups = [], []
    for cid, r in ((3, 2), (9, 8), (1, 5)):
        ad = {"q": {"A": rng.standard_normal((2, 6, r)).astype(np.float32),
                    "B": rng.standard_normal((2, r, 4)).astype(np.float32)}}
        head = {"cls_bias": rng.standard_normal(2).astype(np.float32)}
        jups.append(j_msg.ClientUpdate(cid, 1, 10 * cid, ad, head,
                                       codec=j_compress.from_name(codec)))
        tups.append(t_msg.ClientUpdate(
            cid, 1, 10 * cid, interop.tree_from_numpy(ad, "cpu"),
            interop.tree_from_numpy(head, "cpu"),
            codec=t_compress.from_name(codec)))
    want = j_msg.EdgeAggregate(edge_id=1, updates=jups)
    got = t_msg.EdgeAggregate(edge_id=1, updates=tups)
    assert got.to_bytes() == want.to_bytes()
    assert got.num_bytes == want.num_bytes > sum(u.num_bytes for u in tups)
    for data in (want.to_bytes(), got.to_bytes()):
        back = t_msg.EdgeAggregate.from_bytes(data)
        assert back.edge_id == 1 and len(back.updates) == 3
        assert [u.to_bytes() for u in back.updates] == \
            [u.to_bytes() for u in jups]
    empty = t_msg.EdgeAggregate(edge_id=0, updates=[])
    assert empty.to_bytes() == j_msg.EdgeAggregate(0, []).to_bytes()
    assert t_msg.EdgeAggregate.from_bytes(empty.to_bytes()).updates == []
    with pytest.raises(ValueError, match="edge_aggregate"):
        t_msg.EdgeAggregate.from_bytes(tups[0].to_bytes())


def test_topology_assignment_equals_reference():
    rng = np.random.default_rng(0)
    for cohort in (np.array([3, 9, 14, 2, 7, 21, 6]),
                   rng.choice(1000, 17, replace=False), np.array([5])):
        for e in (1, 2, 3, 5):
            for assignment in ("contiguous", "round_robin", "hash"):
                want = j_topo.HierarchicalTopology(e, assignment).assign(
                    cohort)
                got = t_topo.HierarchicalTopology(e, assignment).assign(
                    cohort)
                assert len(got) == len(want) == e
                for g, w in zip(got, want):
                    _eq(g, w, (e, assignment))
                _eq(np.sort(np.concatenate(got)), np.arange(len(cohort)))
    with pytest.raises(ValueError, match="num_edges"):
        t_topo.HierarchicalTopology(num_edges=0)
    with pytest.raises(ValueError, match="assignment"):
        t_topo.HierarchicalTopology(assignment="ring")
    with pytest.raises(ValueError, match="edge_mode"):
        t_topo.HierarchicalTopology(edge_mode="tree")


def _pair(weights, server, **kw):
    """A session of each package, the port's on the reference's initial
    global adapter, and one sampled cohort with numpy-seeded trained
    factors (each client masked to its rank) and heads, stacked."""
    server = dict(SERVER, **server)
    j = j_session.FedSession(weights["jcfg"], j_session.ServerConfig(
        **server), weights["jparams"], **kw)
    t = t_session.FedSession(weights["tcfg"], t_session.ServerConfig(
        **server), weights["tparams"], device="cpu", **kw)
    t.global_lora = interop.lora_from_jax(_initial_lora(weights, server),
                                          "cpu")
    cohort = j.sample_cohort()
    _eq(t.sample_cohort(), cohort)
    rng = np.random.default_rng(11)
    head0 = _numpy(t.global_head)
    per = [_numpy_update(rng, weights["tcfg"], int(t.ranks[c]), head0)
           for c in cohort]
    tree = {tt: {leaf: np.stack([p[0][tt][leaf] for p in per])
                 for leaf in ("A", "B", "mask")} for tt in per[0][0]}
    heads = {k: np.stack([p[1][k] for p in per]) for k in head0}
    return j, t, cohort, tree, heads


def _aggregate(j, t, topo_kw, cohort, tree, heads):
    j_topo.HierarchicalTopology(**topo_kw).aggregate(
        j, cohort, jax.tree.map(jnp.asarray, tree),
        jax.tree.map(jnp.asarray, heads))
    t_topo.HierarchicalTopology(**topo_kw).aggregate(
        t, cohort, interop.tree_from_numpy(tree, "cpu"),
        interop.tree_from_numpy(heads, "cpu"))


def _hold_global(weights, j, t, what):
    cfg = weights["tcfg"]
    want = _effective(_numpy(j.global_lora), cfg.lora.alpha, cfg.lora.r_max)
    got = _effective(_numpy(t.global_lora), cfg.lora.alpha, cfg.lora.r_max)
    for tt in want:
        _normwise(got[tt], want[tt], UPDATE_REL, f"{what} {tt}")
    for k, v in _numpy(j.global_head).items():
        np.testing.assert_allclose(_numpy(t.global_head)[k], v, **LOSS,
                                   err_msg=f"{what} head {k}")
    if j.last_spectrum is not None:
        _spectrum_close(_numpy(t.last_spectrum), _numpy(j.last_spectrum),
                        what)


@pytest.mark.parametrize("mode", ["stack", "engine"])
@pytest.mark.parametrize("strategy,assignment,codec", [
    ("naive", "contiguous", "none"), ("hlora", "hash", "none"),
    ("hlora", "round_robin", "int8"), ("flora", "contiguous", "topk:3")])
def test_topology_merge_matches_reference(weights, mode, strategy,
                                          assignment, codec):
    """The same trained cohort through each package's topology: the comm
    log (edge rows included) equal, the spans and wire samples on the edge
    tracks equal (times aside), the root's merge within the session
    limits; the session's rng stream stays aligned (the root's draw).

    One exception, named: in 'engine' mode under int8 the edge's message
    encodes the edge's own merge, whose floats differ from the reference's
    in rounding, and its header carries the per-tensor scales as decimal
    floats, whose printed length varies by a digit or two with the last
    bits. There each edge row (and its wire sample) is held to 2 bytes a
    scale (4 scales a message); every other row stays exact."""
    jrec, trec = JRecorder(), Recorder()
    j, t, cohort, tree, heads = _pair(
        weights, dict(strategy=strategy, codec=codec, clients_per_round=4))
    j.rec, t.rec = jrec, trec
    _aggregate(j, t, dict(num_edges=2, assignment=assignment,
                          edge_mode=mode), cohort, tree, heads)
    slack = 2 * 4 if (mode, codec) == ("engine", "int8") else 0
    assert sorted(t.comm_log) == sorted(j.comm_log)
    for key, rows in j.comm_log.items():
        if key.startswith("edge"):
            assert len(t.comm_log[key]) == len(rows), key
            assert all(abs(g - w) <= slack for g, w in zip(
                t.comm_log[key], rows)), (key, t.comm_log[key], rows)
        else:
            assert t.comm_log[key] == rows, key
    assert set(t.comm_log) == {"downlink", "uplink", "edge0_uplink",
                               "edge1_uplink"} or assignment == "hash"
    assert t.rounds_done == j.rounds_done == 1
    _hold_global(weights, j, t, f"{mode} {strategy}")
    assert int(t.rng.integers(2 ** 31)) == int(j.rng.integers(2 ** 31))

    def shape(events):
        return [(e[0], e[1], e[2], {
            k: v for k, v in e[5].items()
            if not (slack and k.startswith("fed.edge"))})
            for e in events]
    assert shape(trec.events()) == shape(jrec.events())
    tracks = {e[2] for e in trec.events()}
    assert "fed.edge0" in tracks or "fed.edge1" in tracks


def _flat_and_topology(weights, strategy, topo, codec="none", rounds=2,
                       rank_policy="random"):
    """Two port runs of ``rounds`` SyncRound rounds from one setup: flat
    and through ``topo``."""
    server = dict(SERVER, strategy=strategy, codec=codec,
                  rank_policy=rank_policy)
    scfg = t_session.ServerConfig(**server)
    sim = t_sim.SimConfig(**dict(SIM, rounds=rounds))
    (kw, train, _local, data_fn, _cdata, eval_fn) = \
        t_sim.make_experiment_setup(weights["tcfg"], sim, scfg,
                                    weights["tparams"], device="cpu")
    out = []
    for tp in (None, topo):
        sess = t_session.FedSession(weights["tcfg"], scfg, device="cpu",
                                    **kw)
        sess.global_lora = interop.lora_from_jax(
            _initial_lora(weights, server), "cpu")
        h = t_sched.SyncRound(topology=tp).run(sess, train, data_fn, rounds,
                                               eval_fn=eval_fn)
        out.append((sess, h))
    return out


@pytest.mark.parametrize("strategy,assignment,codec", [
    ("naive", "contiguous", "none"), ("hlora", "contiguous", "none"),
    ("hlora", "hash", "int8"), ("naive", "round_robin", "bf16")])
def test_stack_mode_is_the_flat_round_bit_for_bit(weights, strategy,
                                                  assignment, codec):
    """Two rounds through 2 edges in 'stack' mode against the flat round:
    history, global factors, masks and head bit for bit, the same uplink
    row, and each edge row its clients' update bytes plus one header."""
    topo = t_topo.HierarchicalTopology(num_edges=2, assignment=assignment,
                                       edge_mode="stack")
    (sf, hf), (sh, hh) = _flat_and_topology(weights, strategy, topo, codec)
    for k in ("round", "train_loss", "eval_acc", "eval_loss",
              "downlink_bytes", "uplink_bytes"):
        assert hh[k] == hf[k], k
    for tt in sf.global_lora:
        for leaf in ("A", "B", "mask"):
            assert torch.equal(sh.global_lora[tt][leaf],
                               sf.global_lora[tt][leaf]), (tt, leaf)
    for k in sf.global_head:
        assert torch.equal(sh.global_head[k], sf.global_head[k])
    assert sh.comm_log["uplink"] == sf.comm_log["uplink"]
    rows = [sh.comm_log.get(f"edge{e}_uplink", []) for e in range(2)]
    assert all(len(r) == 2 for r in rows)
    for i in range(2):
        over = rows[0][i] + rows[1][i] - sh.comm_log["uplink"][i]
        assert 0 < over < 4096, over


def test_engine_mode_under_naive_is_the_weighted_mean(weights):
    """'engine' mode, naive, one round at uniform ranks: the nested
    weighted mean equals the flat round's within the reference test's
    tolerance, and edge→root traffic is below the clients' uplink."""
    topo = t_topo.HierarchicalTopology(num_edges=2, edge_mode="engine")
    (sf, _), (sh, _) = _flat_and_topology(weights, "naive", topo, rounds=1,
                                          rank_policy="uniform")
    alpha = weights["tcfg"].lora.alpha
    for tt in sf.global_lora:
        np.testing.assert_allclose(delta_w(sh.global_lora[tt], alpha).numpy(),
                                   delta_w(sf.global_lora[tt], alpha).numpy(),
                                   **DW, err_msg=tt)
    for k in sf.global_head:
        np.testing.assert_allclose(sh.global_head[k].numpy(),
                                   sf.global_head[k].numpy(), **HEAD,
                                   err_msg=k)
    edges = sh.comm_log["edge0_uplink"][0] + sh.comm_log["edge1_uplink"][0]
    assert edges < sh.comm_log["uplink"][0]
    # and the reference's dW' convention agrees with the port's delta_w
    ad = _numpy(sf.global_lora)["q"]
    np.testing.assert_allclose(
        delta_w(sf.global_lora["q"], alpha).numpy(),
        np.asarray(j_lora.delta_w(jax.tree.map(jnp.asarray, ad), alpha)),
        rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mode", ["stack", "engine"])
def test_track_comm_off_matches_reference(weights, mode):
    """``track_comm=False``: zero rows, the edge rows included, as the
    reference logs them; 'stack' mode is then the flat merge of the
    trained tree itself."""
    j, t, cohort, tree, heads = _pair(weights, dict(strategy="hlora"),
                                      track_comm=False)
    _aggregate(j, t, dict(num_edges=2, edge_mode=mode), cohort, tree, heads)
    assert t.comm_log == j.comm_log
    assert t.comm_log["uplink"] == [0] and t.comm_log["edge0_uplink"] == [0]
    _hold_global(weights, j, t, f"{mode} track_comm=False")


# ---------------------------------------------------------------------------
# the example's population path
# ---------------------------------------------------------------------------

def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorded(pkg_session, pkg_topology, log, initial=None, anchors=None):
    """A FedSession subclass and a HierarchicalTopology subclass of one
    package that log each round's cohort and ranks, trained cohort and
    state after the merge into ``log``. With ``anchors`` (the reference's
    log) the session starts on ``initial``, is put back on the reference's
    state before each broadcast, and the trained cohort is held to the
    reference's client by client and replaced by it."""

    class Session(pkg_session):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            log["session"] = self
            if initial is not None:
                self.global_lora = interop.lora_from_jax(initial, "cpu")

        def sample_cohort(self):
            cohort = super().sample_cohort()
            log["rounds"].append({
                "cohort": [int(c) for c in cohort],
                "ranks": [self._client_ranks(int(c)) for c in cohort]})
            return cohort

        def broadcast_cohort(self, cohort):
            done = self.rounds_done
            if anchors is not None and done > 0:
                prev = anchors["rounds"][done - 1]
                self.global_lora = interop.lora_from_jax(prev["lora"], "cpu")
                self.global_head = interop.tree_from_numpy(prev["head"],
                                                           "cpu")
            return super().broadcast_cohort(cohort)

        def aggregate_round(self, tree, cohort, **kw):
            super().aggregate_round(tree, cohort, **kw)
            spec = self.last_spectrum
            log["rounds"][-1].update(
                lora=_numpy(self.global_lora), head=_numpy(self.global_head),
                spectrum=None if spec is None else _numpy(spec))

    class Topology(pkg_topology):
        def aggregate(self, session, cohort, trained_tree,
                      trained_heads=None):
            i = len(log["rounds"]) - 1
            rec = log["rounds"][i]
            rec["trained"] = (_numpy(trained_tree), _numpy(trained_heads))
            if anchors is not None:
                (wt, wh), (gt, gh) = anchors["rounds"][i]["trained"], \
                    rec["trained"]
                for k in range(len(cohort)):
                    _hold_trained(*(
                        ({tt: {x: v[k] for x, v in ad.items()}
                          for tt, ad in tr.items()},
                         {x: v[k] for x, v in hd.items()})
                        for tr, hd in ((wt, wh), (gt, gh))),
                        f"round {i} client {cohort[k]}")
                trained_tree = interop.tree_from_numpy(wt, "cpu")
                trained_heads = interop.tree_from_numpy(wh, "cpu")
            return super().aggregate(session, cohort, trained_tree,
                                     trained_heads)

    return Session, Topology


def test_run_population_matches_reference(weights, monkeypatch, capsys):
    """``run_population`` of each example on roberta-reduced from the
    reference's weights: 300 clients, a cohort of 4 (sample rate 0.015),
    the rank-stratified sampler, 2 edges in 'stack' mode, int8 on the
    wire, 2 rounds. The port's run anchored: cohorts, ranks, every byte
    (history, comm log with edge rows, health rows) and the residency
    counters equal, the losses within 1e-4 (``LOSS``), every merge within
    the session limits, and the example's report printed alike."""
    jex = _load("fed_finetune_reference", ROOT / "examples" /
                "fed_finetune.py")
    tex = _load("fed_finetune_port", ROOT / "examples" /
                "fed_finetune_torch.py")
    args = argparse.Namespace(population=300, sample_rate=0.015, edges=2,
                              codec="int8", rounds=2, task="mrpc", seed=0,
                              scheduler="sync", device="cpu")
    sim = dict(SIM, task="mrpc", rounds=2)
    jlog, tlog = {"rounds": []}, {"rounds": []}
    jsess, jtopo = _recorded(j_session.FedSession,
                             j_topo.HierarchicalTopology, jlog)
    monkeypatch.setattr(jex, "FedSession", jsess)
    monkeypatch.setattr(jex, "HierarchicalTopology", jtopo)
    monkeypatch.setattr(jex, "pretrain_backbone",
                        lambda cfg, sim: weights["jparams"])

    class History(j_sched.SyncRound):
        def run(self, *a, **kw):
            jlog["hist"] = super().run(*a, **kw)
            return jlog["hist"]
    monkeypatch.setattr(jex, "SyncRound", History)
    jex.run_population(weights["jcfg"], j_sim.SimConfig(**sim), args)
    jout = capsys.readouterr().out
    tsess, ttopo = _recorded(t_session.FedSession,
                             t_topo.HierarchicalTopology, tlog,
                             _initial_lora(weights, SERVER), jlog)
    monkeypatch.setattr(tex, "FedSession", tsess)
    monkeypatch.setattr(tex, "HierarchicalTopology", ttopo)
    hist, sess = tex.run_population(weights["tcfg"], t_sim.SimConfig(**sim),
                                    args, base_params=weights["tparams"])
    tout = capsys.readouterr().out
    assert sess is tlog["session"]
    assert len(tlog["rounds"]) == len(jlog["rounds"]) == 2
    j, pop, jpop = jlog["session"], sess.population, jlog["session"].\
        population
    assert pop.size == 300 and sess.scfg.clients_per_round == 4
    assert sess.codec.name == "int8"
    assert pop.materialized_total == jpop.materialized_total == 8
    assert pop.max_resident == jpop.max_resident == 4
    assert sess.comm_log == j.comm_log
    assert set(sess.comm_log) == {"downlink", "uplink", "edge0_uplink",
                                  "edge1_uplink"}
    for want, got in zip(jlog["rounds"], tlog["rounds"]):
        assert got["cohort"] == want["cohort"]
        assert got["ranks"] == want["ranks"]
    jhist = jlog["hist"]
    for k in ("round", "downlink_bytes", "uplink_bytes", "health"):
        assert hist[k] == jhist[k], k
    np.testing.assert_allclose(hist["train_loss"], jhist["train_loss"],
                               **LOSS)
    for i, (want, got) in enumerate(zip(jlog["rounds"], tlog["rounds"])):
        cfg = weights["tcfg"]
        ew = _effective(want["lora"], cfg.lora.alpha, cfg.lora.r_max)
        eg = _effective(got["lora"], cfg.lora.alpha, cfg.lora.r_max)
        for tt in ew:
            _normwise(eg[tt], ew[tt], UPDATE_REL, f"round {i} {tt}")
        for k, v in want["head"].items():
            np.testing.assert_allclose(got["head"][k], v, **LOSS)
    # the report: the same lines but the losses' last digits
    strip = [ln for ln in tout.splitlines() if not ln.startswith(
        "train_loss")]
    assert strip == [ln for ln in jout.splitlines()
                     if not ln.startswith("train_loss")]
