"""The port's checkpoint store and ``FedSession.save``/``restore`` against
the reference's, on the CPU.

The store: each package reads what the other wrote, leaf for leaf with the
same dtype and bits (float32, int32, int64, bfloat16 as its 16-bit
pattern, ``bytes``, nesting), the same ``meta.json``, ``latest_step`` and
``.npz`` keys, and the two ``atomic_write_json``s write the same text.

The session, on roberta-reduced (2 layers, d_model 128, LoRA on q and v at
r_max 8) from the reference's weights, hlora ``factored`` with the spectrum
policy and per-target ranks (``tests/test_torch_session.py``'s SIM and
SERVER), so that ``target_ranks`` and the ranks move:

- in the port, 2 rounds + save + restore + 2 rounds equal 4 rounds bit for
  bit (losses, eval metrics, bytes, cohorts, ranks, global factors, head);
- across packages, each package's session after 2 rounds from the same
  initial adapter saves the same ``meta.json`` (rounds, ``target_ranks``,
  strategy, rng state, comm log: integers, exact); then the checkpoint of
  each is restored by both packages: the restored state equals the
  writer's, and the next round of the two restored sessions is held as
  ``tests/test_torch_session.py`` holds an anchored round (both start from
  the checkpoint's state): integers equal (cohort, ranks, bytes, health),
  losses rtol 1e-4 / atol 1e-5, the effective global update 1e-4 normwise,
  spectra rtol 1e-4, eval accuracy equal up to examples whose reference
  logit margin is below 1e-3;
- the saved strategy is re-applied and an explicit one wins; a restored
  session has no spectrum, and the factor-norm fallback picks the same
  per-target ranks under both splits; a restored staleness log feeds the
  first health row as the reference's does; an ``async`` subtree is
  refused.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as j_store
from repro.configs import get_reduced as j_get_reduced
from repro.core import agg_engine as j_engine
from repro.fed import schedulers as j_sched
from repro.fed import session as j_session
from repro.fed import simulation as j_sim
from repro.models import model as j_model
from repro.util import atomic_write_json as j_atomic_write_json
from repro_torch import interop
from repro_torch.checkpoint import store as t_store
from repro_torch.configs import get_reduced
from repro_torch.fed import schedulers as t_sched
from repro_torch.fed import session as t_session
from repro_torch.fed import simulation as t_sim
from repro_torch.fed.strategies import FLoRAStacking
from repro_torch.util import atomic_write_json as t_atomic_write_json
from test_torch_session import (LOSS, SERVER, SIM, _hold_eval,
                                _hold_integers, _hold_round, _initial_lora,
                                _recording)

SPECTRUM = dict(SERVER, strategy="hlora", rank_policy="spectrum",
                per_target_ranks=True)
META = {"round": 7, "ranks": {"q": 2, "v": 4}, "note": "r∈[2,8]"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread avoids thread-pool
    overhead and contention with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def _bf16_bits() -> np.ndarray:
    """bfloat16 bit patterns: random finite values, and -0, +-inf, the
    smallest subnormal and the largest finite value."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2 ** 16, size=(4, 6), dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] &= 0xBFFF      # no inf or NaN here
    bits.ravel()[:5] = [0x8000, 0x7F80, 0xFF80, 0x0001, 0x7F7F]
    return bits


def _leaves() -> dict:
    """{path: leaf} of the tree both packages write: numpy arrays (the
    bfloat16 one as its uint16 bits) and one ``bytes`` leaf."""
    rng = np.random.default_rng(2)
    return {
        ("w",): rng.standard_normal((3, 5)).astype(np.float32),
        ("nested", "b16"): _bf16_bits(),
        ("nested", "i32"): np.arange(-3, 4, dtype=np.int32),
        ("nested", "deeper", "i64"): np.array([2 ** 40, -1, 0], np.int64),
        ("nested", "deeper", "scalar"): np.array(1.5, np.float32),
        ("nested", "empty"): np.zeros((0, 4), np.float32),
        ("blob",): bytes(range(256)) + b"wire",
    }


def _tree(leaves: dict, leaf_fn) -> dict:
    out = {}
    for path, v in leaves.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v if isinstance(v, bytes) else leaf_fn(path, v)
    return out


def _reference_leaf(path, v):
    if path[-1] == "b16":
        return jnp.asarray(v.view(jnp.bfloat16))
    if v.dtype == np.int64:          # jnp would take it to int32
        return v
    return jnp.asarray(v)


def _port_leaf(path, v):
    t = torch.from_numpy(v.copy())
    if path[-1] == "b16":
        return t.view(torch.int16).view(torch.bfloat16)
    if path[-1] == "w":              # a non-contiguous leaf that has a grad
        return t.t().contiguous().t().requires_grad_(True)
    return t


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _dtype_and_bits(leaf):
    """(dtype name, shape, raw bytes) of a numpy or torch leaf."""
    if isinstance(leaf, bytes):
        return "bytes", (len(leaf),), leaf
    if isinstance(leaf, torch.Tensor):
        assert leaf.device.type == "cpu"
        name = str(leaf.dtype).split(".")[-1]
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.int16)
        arr = leaf.detach().contiguous().numpy()
        return name, arr.shape, arr.tobytes()
    arr = np.asarray(leaf)
    return arr.dtype.name, arr.shape, np.ascontiguousarray(arr).tobytes()


def _want(path, v):
    if isinstance(v, bytes):
        return "bytes", (len(v),), v
    return ("bfloat16" if path[-1] == "b16" else v.dtype.name), v.shape, \
        v.tobytes()


def _write(package, ckpt_dir, step, meta):
    leaves = _leaves()
    if package == "reference":
        return j_store.save(ckpt_dir, step, _tree(leaves, _reference_leaf),
                            meta=meta)
    return t_store.save(ckpt_dir, step, _tree(leaves, _port_leaf), meta=meta)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_crosses_packages(tmp_path, writer):
    d = str(tmp_path / "ck")
    _write(writer, d, 3, dict(META, round=3))
    path = _write(writer, d, 7, META)
    assert path == os.path.join(d, "step_00000007")
    assert j_store.latest_step(d) == t_store.latest_step(d) == 7
    jtree, jmeta = j_store.restore(d)
    ttree, tmeta = t_store.restore(d, device="cpu")
    assert jmeta == tmeta == {"step": 7, **META}
    for path, v in _leaves().items():
        want = _want(path, v)
        assert _dtype_and_bits(_at(jtree, path)) == want, ("reference", path)
        assert _dtype_and_bits(_at(ttree, path)) == want, ("port", path)
    assert set(ttree) == set(jtree) == {"w", "nested", "blob"}
    _, meta3 = t_store.restore(d, step=3, device="cpu")
    assert meta3["round"] == 3


def test_store_writes_the_same_files(tmp_path):
    """The same tree through each package: the same ``.npz`` keys holding
    the same dtypes and bits, and the same ``meta.json`` text."""
    dirs = {w: _write(w, str(tmp_path / w), 5, META)
            for w in ("reference", "port")}
    with np.load(os.path.join(dirs["reference"], "arrays.npz")) as j, \
            np.load(os.path.join(dirs["port"], "arrays.npz")) as t:
        assert sorted(t.files) == sorted(j.files) == sorted(
            ["w", "nested/b16__bf16__", "nested/i32", "nested/deeper/i64",
             "nested/deeper/scalar", "nested/empty", "blob__bytes__"])
        for k in j.files:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
            assert t[k].tobytes() == j[k].tobytes(), k
    texts = [open(os.path.join(d, "meta.json")).read() for d in
             dirs.values()]
    assert texts[0] == texts[1]


@pytest.mark.parametrize("kwargs", [{}, {"indent": 1},
                                    {"indent": 2, "sort_keys": True}])
def test_atomic_write_json_same_text(tmp_path, kwargs):
    obj = {"b": [1, 2.5, None, True], "a": {"r∈": "[2,8]", "x": 1e-300},
           "round": list(range(3))}
    j_atomic_write_json(str(tmp_path / "j" / "h.json"), obj, **kwargs)
    t_atomic_write_json(str(tmp_path / "t" / "h.json"), obj, **kwargs)
    text = (tmp_path / "t" / "h.json").read_text()
    assert text == (tmp_path / "j" / "h.json").read_text()
    assert json.loads(text) == obj
    assert sorted(os.listdir(tmp_path / "t")) == ["h.json"]   # no tmp left


def test_store_empty_and_missing(tmp_path):
    assert t_store.latest_step(str(tmp_path / "nothing")) is None
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "step_12.tmp").mkdir()      # not a step
    assert t_store.latest_step(str(tmp_path / "empty")) is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        t_store.restore(str(tmp_path / "empty"), device="cpu")


def test_store_reads_onto_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately means it")
    d = str(tmp_path / "ck")
    _write("port", d, 1, META)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_store.restore(d)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_store.load_pytree(os.path.join(d, "step_00000001", "arrays.npz"))


# ---------------------------------------------------------------------------
# FedSession.save / restore
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = j_get_reduced("roberta-large"), get_reduced("roberta-large")
    jparams = j_model.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams)


def _port_setup(weights, server, sim=SIM):
    scfg = t_session.ServerConfig(**server)
    kw, train, _, data_fn, _, eval_fn = t_sim.make_experiment_setup(
        weights["tcfg"], t_sim.SimConfig(**sim), scfg, weights["tparams"],
        device="cpu")
    return dict(scfg=scfg, sizes=kw["client_sizes"], train=train,
                data_fn=data_fn, eval_fn=eval_fn)


def _reference_setup(weights, server, sim=SIM):
    scfg = j_session.ServerConfig(**server)
    kw, train, _, data_fn, _, eval_fn = j_sim.make_experiment_setup(
        weights["jcfg"], j_sim.SimConfig(**sim), scfg, weights["jparams"])
    return dict(scfg=scfg, sizes=kw["client_sizes"], train=train,
                data_fn=data_fn, eval_fn=eval_fn)


def _port_session(weights, setup):
    return t_session.FedSession(weights["tcfg"], setup["scfg"],
                                weights["tparams"],
                                client_sizes=setup["sizes"], device="cpu")


def _port_restore(weights, setup, ckpt, **kw):
    return t_session.FedSession.restore(
        ckpt, weights["tcfg"], setup["scfg"], weights["tparams"],
        client_sizes=setup["sizes"], device="cpu", **kw)


def _reference_session_kw(setup):
    return dict(client_sizes=setup["sizes"],
                engine=j_engine.AggregationEngine(use_pallas=False))


def _run(package, session, setup, rounds):
    sched = _recording(t_sched.SyncRound if package == "port"
                       else j_sched.SyncRound)
    hist = sched.run(session, setup["train"], setup["data_fn"], rounds,
                     eval_fn=setup["eval_fn"])
    return hist, sched.log


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().view(torch.int32).numpy()


def _same_tensors(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        if isinstance(v, dict):
            _same_tensors(got[k], v, f"{what}/{k}")
            continue
        g = got[k]
        if isinstance(g, torch.Tensor):
            assert g.device.type == "cpu", (what, k)
            g = _bits(g)
        else:
            g = np.asarray(g).view(np.int32)
        w = _bits(v) if isinstance(v, torch.Tensor) \
            else np.asarray(v).view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}/{k}")


def test_session_resume_is_bitwise(weights, tmp_path):
    """2 rounds, save, restore into a fresh session, 2 more rounds: the
    same history and state as 4 rounds without a break, bit for bit."""
    setup = _port_setup(weights, SPECTRUM)
    full = _port_session(weights, setup)
    h_full, log_full = _run("port", full, setup, 4)
    first = _port_session(weights, setup)
    h_a, log_a = _run("port", first, setup, 2)
    ckpt = str(tmp_path / "fed")
    assert first.save(ckpt) == os.path.join(ckpt, "step_00000002")
    back = _port_restore(weights, setup, ckpt)
    assert back.rounds_done == 2 and back.version == 0
    assert back.last_spectrum is None
    np.testing.assert_array_equal(back.ranks, first.ranks)
    assert back.ranks.dtype == np.int32
    assert back.target_ranks == first.target_ranks
    assert back.comm_log == first.comm_log
    assert back.rng.bit_generator.state == first.rng.bit_generator.state
    assert back.strategy.name == "hlora"
    _same_tensors(back.global_lora, first.global_lora, "lora")
    _same_tensors(back.global_head, first.global_head, "head")
    h_b, log_b = _run("port", back, setup, 2)
    for k in ("round", "train_loss", "eval_acc", "eval_loss",
              "downlink_bytes", "uplink_bytes"):
        assert h_a[k] + h_b[k] == h_full[k], k
    for want, got in zip(log_full, log_a + log_b):
        for k in ("cohort", "ranks", "post_ranks", "target_ranks"):
            assert got[k] == want[k], k
    _same_tensors(back.global_lora, full.global_lora, "lora after 4")
    _same_tensors(back.global_head, full.global_head, "head after 4")
    assert back.comm_log == full.comm_log


@pytest.fixture(scope="module")
def saved(weights, tmp_path_factory):
    """Each package's session after the same 2 rounds (the port's from the
    reference session's initial adapter), saved."""
    root = tmp_path_factory.mktemp("saved")
    jsetup = _reference_setup(weights, SPECTRUM)
    jsess = j_session.FedSession(weights["jcfg"], jsetup["scfg"],
                                 weights["jparams"],
                                 **_reference_session_kw(jsetup))
    _run("reference", jsess, jsetup, 2)
    tsetup = _port_setup(weights, SPECTRUM)
    tsess = _port_session(weights, tsetup)
    tsess.global_lora = interop.lora_from_jax(
        _initial_lora(weights, SPECTRUM), "cpu")
    _run("port", tsess, tsetup, 2)
    dirs = {"reference": str(root / "reference"), "port": str(root / "port")}
    jsess.save(dirs["reference"])
    tsess.save(dirs["port"])
    return dict(dirs=dirs, reference=jsess, port=tsess, jsetup=jsetup,
                tsetup=tsetup)


def _meta(ckpt_dir):
    with open(os.path.join(ckpt_dir, "step_00000002", "meta.json")) as f:
        return json.load(f)


def test_session_saves_the_reference_meta(saved):
    """After the same 2 rounds both packages save the same meta, key for
    key: every value in it is an integer, a name or the rng's state."""
    jmeta, tmeta = (_meta(saved["dirs"][w]) for w in ("reference", "port"))
    assert list(tmeta) == list(jmeta) == [
        "step", "rounds_done", "version", "staleness_log", "target_ranks",
        "strategy", "rng_state", "comm_log"]
    assert tmeta == jmeta
    assert tmeta["target_ranks"] is not None and tmeta["rounds_done"] == 2
    with np.load(os.path.join(saved["dirs"]["port"], "step_00000002",
                              "arrays.npz")) as t, \
            np.load(os.path.join(saved["dirs"]["reference"],
                                 "step_00000002", "arrays.npz")) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_session_restores_across_packages(weights, saved, writer):
    """Both packages restore ``writer``'s checkpoint to ``writer``'s
    state; their next round agrees as an anchored round does."""
    ckpt, src = saved["dirs"][writer], saved[writer]
    jsetup, tsetup = saved["jsetup"], saved["tsetup"]
    jsess = j_session.FedSession.restore(
        ckpt, weights["jcfg"], jsetup["scfg"], weights["jparams"],
        **_reference_session_kw(jsetup))
    tsess = _port_restore(weights, tsetup, ckpt)
    for sess in (jsess, tsess):
        assert sess.rounds_done == src.rounds_done == 2
        np.testing.assert_array_equal(np.asarray(sess.ranks), src.ranks)
        assert sess.target_ranks == src.target_ranks
        assert sess.comm_log == src.comm_log
        assert sess.rng.bit_generator.state == src.rng.bit_generator.state
    want = src.global_lora if writer == "port" else jax.tree.map(
        np.asarray, src.global_lora)
    _same_tensors(tsess.global_lora, want, f"{writer}'s lora")
    nxt = np.random.default_rng()
    nxt.bit_generator.state = src.rng.bit_generator.state
    cohort = nxt.choice(SERVER["num_clients"],
                        size=SERVER["clients_per_round"], replace=False)
    jhist, jlog = _run("reference", jsess, jsetup, 1)
    thist, tlog = _run("port", tsess, tsetup, 1)
    assert tlog[0]["cohort"] == jlog[0]["cohort"] == cohort.tolist()
    _hold_integers(jhist, jlog, thist, tlog)
    assert thist["round"] == [2]
    np.testing.assert_allclose(thist["train_loss"], jhist["train_loss"],
                               **LOSS)
    _hold_round(weights, jlog[0], tlog[0], f"round 2 from {writer}'s")
    _hold_eval(weights, jhist, jlog, thist, [0])


def test_restore_reapplies_saved_strategy(weights, tmp_path):
    """A session saved under 'flora' resumes under flora, whichever
    package saved it; an explicit strategy still wins."""
    setup = _port_setup(weights, dict(SERVER, strategy="hlora"))
    d = str(tmp_path / "port")
    t_session.FedSession(weights["tcfg"], setup["scfg"], weights["tparams"],
                         client_sizes=setup["sizes"], strategy="flora",
                         device="cpu").save(d)
    j = str(tmp_path / "reference")
    j_session.FedSession(weights["jcfg"],
                         j_session.ServerConfig(**dict(SERVER,
                                                       strategy="hlora")),
                         weights["jparams"], client_sizes=setup["sizes"],
                         strategy="flora").save(j)
    for ckpt in (d, j):
        back = _port_restore(weights, setup, ckpt)
        assert isinstance(back.strategy, FLoRAStacking), ckpt
        forced = _port_restore(weights, setup, ckpt, strategy="naive")
        assert forced.strategy.name == "naive"


def test_restored_session_spectrum_fallback(weights, tmp_path):
    """A restored session has no engine spectrum: ``adapt_ranks`` runs on
    the split-normalized factor-norm fallback and picks the same
    per-target ranks under both splits, q 2 and v 4."""
    s_by_target = {"q": np.array([8.0, 4.0] + [1e-3] * 6),
                   "v": np.array([5.0, 4.0, 3.0, 2.0] + [1e-3] * 4)}
    picked = {}
    for split in ("paper", "sqrt"):
        setup = dict(scfg=t_session.ServerConfig(
            num_clients=6, clients_per_round=3, strategy="hlora",
            rank_policy="spectrum", per_target_ranks=True, split=split,
            r_min=2, r_max=8, seed=0), sizes=np.full(6, 32))
        sess = _port_session(weights, setup)
        for t, ad in sess.global_lora.items():
            s = s_by_target[t]
            rows = s if split == "paper" else np.sqrt(s)
            b = np.zeros(tuple(ad["B"].shape), np.float32)
            b[..., 0] = rows
            sess.global_lora[t]["B"] = torch.from_numpy(b)
        ckpt = str(tmp_path / f"fed_{split}")
        sess.save(ckpt)
        restored = _port_restore(weights, setup, ckpt)
        assert restored.last_spectrum is None
        restored.adapt_ranks()
        picked[split] = dict(restored.target_ranks)
    assert picked["paper"] == picked["sqrt"], picked
    assert picked["paper"]["q"] == 2 and picked["paper"]["v"] == 4


def test_restore_refuses_async_state(weights, tmp_path):
    """A checkpoint taken inside a BufferedAsync run carries an ``async``
    subtree (heap, pending adapters, the K-buffer's wire bytes): the async
    merge is ported, so restoring it brings that state back, never drops
    it: the heap as Python (float, int, int) tuples in its list order, the
    pending adapters on the session's device, the buffer's updates with
    the same bytes; the step before it has no async state."""
    setup = _port_setup(weights, SERVER)
    d = str(tmp_path / "fed")
    sess = _port_session(weights, setup)
    sess.save(d)
    tree, meta = t_store.restore(d, device="cpu")
    pending = {cid: sess.adapter_for(cid)[0] for cid in (1, 0)}
    upd = sess.make_update(1, pending[1], 0, head=sess.global_head)
    tree["async"] = {
        "heap": {"t": np.array([0.5, 1.0]), "cid": np.array([1, 0]),
                 "ver": np.array([0, 0])},
        "pending": {f"{cid:08d}": ad for cid, ad in pending.items()},
        "buffer": {"000000": upd.to_bytes()}}
    meta.pop("step")
    t_store.save(d, 1, tree, meta)
    back = _port_restore(weights, setup, d)
    st = back.async_state
    assert st["heap"] == [(0.5, 1, 0), (1.0, 0, 0)]
    assert all(type(x) is float and type(c) is int and type(v) is int
               for x, c, v in st["heap"])
    assert sorted(st["pending"]) == [0, 1]
    for cid, ad in pending.items():
        for t in ad:
            for leaf in ("A", "B", "mask"):
                got = st["pending"][cid][t][leaf]
                assert got.device.type == "cpu"
                assert torch.equal(got, ad[t][leaf]), (cid, t, leaf)
    assert [u.to_bytes() for u in st["buffer"]] == [upd.to_bytes()]
    assert st["buffer"][0].client_id == 1
    assert _port_restore(weights, setup, d, step=0).async_state is None


def test_restored_staleness_log_feeds_health(weights, tmp_path):
    """A reference checkpoint whose session merged async updates carries
    their staleness: both packages' restored sessions report it in their
    first health row alike."""
    setup = _port_setup(weights, SERVER)
    jsess = j_session.FedSession(
        weights["jcfg"], j_session.ServerConfig(**SERVER),
        weights["jparams"], client_sizes=setup["sizes"])
    jsess.staleness_log = [0, 3, 1, 2, 0]
    d = str(tmp_path / "fed")
    jsess.save(d)
    jrow = j_session.FedSession.restore(
        d, weights["jcfg"], jsess.scfg, weights["jparams"],
        client_sizes=setup["sizes"]).health_snapshot()
    back = _port_restore(weights, setup, d)
    assert back.staleness_log == [0, 3, 1, 2, 0]
    trow = back.health_snapshot()
    assert trow == jrow
    assert trow["staleness_p50"] == 1.0 and trow["staleness_p99"] == 3.0
    assert back.health_snapshot()["staleness_p99"] == 0.0   # none since


def test_session_restore_needs_the_card_by_default(weights, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately means it")
    setup = _port_setup(weights, SERVER)
    d = str(tmp_path / "fed")
    _port_session(weights, setup).save(d)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_session.FedSession.restore(d, weights["tcfg"], setup["scfg"],
                                     weights["tparams"],
                                     client_sizes=setup["sizes"])
