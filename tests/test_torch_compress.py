"""The port's wire codecs (``repro_torch/fed/compress.py``) and the codec
path of its messages and session against the reference's, on the CPU.

An encoded message must be the reference's byte for byte for the same
inputs (the reference's numpy arrays, the port's tensors made from them):
int8's quotient is a float32 division, as numpy's, rounded half to even;
topk's scores are float64 norms and its kept directions come from a stable
sort (an all-zero score keeps the first k); bf16 rounds to nearest even.
A message encoded by either package decodes in the other to the same
bits. The session carries its codec into every ``Broadcast`` and
``ClientUpdate`` (the same bytes and comm log as the reference's), and a
``BufferedAsync`` run with a codec, anchored to the reference's state as
``tests/test_torch_async.py`` anchors it, keeps every byte column and
event integer and each flush within that file's limits.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import agg_engine as j_engine
from repro.fed import compress as j_compress
from repro.fed import messages as j_msg
from repro.fed import schedulers as j_sched
from repro.fed import session as j_session
from repro.fed import simulation as j_sim
from repro_torch.fed import compress as t_compress
from repro_torch.fed import messages as t_msg
from repro_torch.fed import schedulers as t_sched
from repro_torch.fed import session as t_session
from repro_torch.fed import simulation as t_sim
from test_torch_async import _hold_async, _holder, _recording
from test_torch_session import (SERVER, SIM, _initial_lora,  # noqa: F401
                                _numpy, _one_torch_thread, weights)

CODECS = ["bf16", "int8", "topk", "topk:1", "topk:3", "topk:8"]


def _adapter(seed, layers=2, d_in=6, d_out=5, r=4):
    """A float32 payload with a spread of magnitudes per rank direction,
    as truncated factors have on the wire (the reference's test payload)."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((layers, d_in, r))
         * np.geomspace(1.0, 0.01, r)).astype(np.float32)
    b = (rng.standard_normal((layers, r, d_out))
         * np.geomspace(1.0, 0.01, r)[:, None]).astype(np.float32)
    return {"q": {"A": a, "B": b}, "v": {"A": 2 * a, "B": 0.5 * b}}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(
        np.array(v)) for k, v in tree.items()}


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _head(seed):
    rng = np.random.default_rng(seed)
    return {"cls_head": rng.standard_normal((5, 2)).astype(np.float32),
            "cls_bias": rng.standard_normal(2).astype(np.float32)}


def _messages(adapter, head, codec):
    """A Broadcast and a ClientUpdate of each package, both encoded."""
    jc, tc = j_compress.from_name(codec), t_compress.from_name(codec)
    ta, th = _t(adapter), _t(head)
    return ([j_msg.Broadcast(version=3, client_id=7, adapter=adapter,
                             head=head, codec=jc),
             j_msg.ClientUpdate(client_id=7, start_version=2,
                                num_examples=41, adapter=adapter, head=head,
                                codec=jc)],
            [t_msg.Broadcast(version=3, client_id=7, adapter=ta, head=th,
                             codec=tc),
             t_msg.ClientUpdate(client_id=7, start_version=2,
                                num_examples=41, adapter=ta, head=th,
                                codec=tc)])


def _hold_same_messages(adapter, head, codec):
    jmsgs, tmsgs = _messages(adapter, head, codec)
    for jm, tm in zip(jmsgs, tmsgs):
        assert tm.to_bytes() == jm.to_bytes(), (codec, jm.kind)
        assert tm.num_bytes == jm.num_bytes
        # each package decodes the other's message to the same bits
        for data in (jm.to_bytes(), tm.to_bytes()):
            jd = type(jm).from_bytes(data)
            td = type(tm).from_bytes(data)
            for t in jd.adapter:
                for leaf in ("A", "B"):
                    np.testing.assert_array_equal(
                        _bits(td.adapter[t][leaf]),
                        _bits(jd.adapter[t][leaf]), err_msg=(codec, t, leaf))
            for k in jd.head:
                np.testing.assert_array_equal(_bits(td.head[k]),
                                              _bits(jd.head[k]))
    return jmsgs, tmsgs


# ---------------------------------------------------------------------------
# each codec alone, bytes and decoded bits
# ---------------------------------------------------------------------------

@settings(deadline=None, max_examples=25)
@given(seed=st.integers(0, 10_000), r=st.integers(1, 8),
       layers=st.integers(1, 3))
def test_int8_bytes_equal_reference(seed, r, layers):
    """Per-tensor int8: the same codes, the same scales in the header (the
    same Python floats, so the same JSON), each package's error within
    scale / 2."""
    adapter = _adapter(seed, layers=layers, r=r)
    jmsgs, _ = _hold_same_messages(adapter, _head(seed), "int8")
    arrays, meta = t_compress.Int8Codec().encode_adapter(_t(adapter))
    jarr, jmeta = j_compress.Int8Codec().encode_adapter(adapter)
    assert json.dumps(meta) == json.dumps(jmeta)
    back = t_compress.Int8Codec().decode_adapter(arrays, meta)
    for t, ad in adapter.items():
        for leaf in ("A", "B"):
            assert arrays[f"{t}/{leaf}"].dtype == torch.int8
            np.testing.assert_array_equal(arrays[f"{t}/{leaf}"].numpy(),
                                          jarr[f"{t}/{leaf}"])
            scale = meta[t][f"{leaf}_scale"]
            assert type(scale) is float
            err = np.abs(back[t][leaf].numpy() - ad[leaf])
            assert err.max() <= scale / 2 + 1e-7, (t, leaf)


def test_int8_rounds_half_to_even_by_a_float32_division():
    """Quotients that land exactly on half-integers round to even (scales
    of 0.5, 1 and 2, whose quotients are exact), an all-zero tensor takes
    scale 1.0, and quotients near half-integers at arbitrary scales (a
    float32 division, as numpy's, no reciprocal) give the reference's
    codes."""
    a = np.asarray([[127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, 126.5]],
                   np.float32)
    codes = [127, 0, 2, 2, -2, 0, 4, 126]
    for mul in (0.5, 1.0, 2.0):
        adapter = {"q": {"A": a * mul, "B": np.zeros((8, 3), np.float32)}}
        _hold_same_messages(adapter, {}, "int8")
        arrays, meta = t_compress.Int8Codec().encode_adapter(_t(adapter))
        assert meta["q"]["A_scale"] == mul and meta["q"]["B_scale"] == 1.0
        assert arrays["q/A"][0].tolist() == codes
        assert arrays["q/B"].abs().sum() == 0
    rng = np.random.default_rng(3)
    for _ in range(20):      # many quotients near half-integers
        x = (rng.integers(-254, 255, size=(64, 8)) / 2.0
             * rng.uniform(1e-3, 1e2)).astype(np.float32)
        _hold_same_messages({"q": {"A": x, "B": x.T.copy()}}, {}, "int8")


@settings(deadline=None, max_examples=15)
@given(seed=st.integers(0, 10_000), r=st.integers(1, 8),
       k=st.integers(1, 10))
def test_topk_bytes_equal_reference(seed, r, k):
    _hold_same_messages(_adapter(seed, r=r), _head(seed), f"topk:{k}")


@pytest.mark.parametrize("k", [1, 3, 8])
def test_topk_all_zero_scores_keep_the_first_directions(k):
    """A round-0 broadcast carries B = 0: every score is 0 and the stable
    sort keeps the first k directions, in both packages; topk at k >= r
    is the raw factors, bit for bit."""
    adapter = _adapter(5, r=6)
    for ad in adapter.values():
        ad["B"] = np.zeros_like(ad["B"])
    _hold_same_messages(adapter, {}, f"topk:{k}")
    _, meta = t_compress.TopKCodec(k).encode_adapter(_t(adapter))
    assert meta["q"]["keep"] == list(range(min(k, 6)))
    # ties among equal non-zero scores break by position too
    tied = {"q": {"A": np.ones((2, 4, 5), np.float32),
                  "B": np.ones((2, 5, 3), np.float32)}}
    _hold_same_messages(tied, {}, f"topk:{k}")
    full = _adapter(9, r=5)
    codec = t_compress.TopKCodec(8)
    back = codec.decode_adapter(*codec.encode_adapter(_t(full)))
    for t, ad in full.items():
        for leaf in ("A", "B"):
            np.testing.assert_array_equal(back[t][leaf].numpy(), ad[leaf])


@pytest.mark.parametrize("k", [1, 2, 3])
def test_topk_keeps_the_most_energetic_directions(k):
    """Dropped directions decode to exact zeros and the kept ones to the
    raw factors; the kept ones are the largest scores."""
    adapter = _adapter(11, r=4)
    perm = [2, 0, 3, 1]          # direction energy order no longer 0..3
    for ad in adapter.values():
        ad["A"], ad["B"] = ad["A"][..., perm], ad["B"][..., perm, :]
    codec = t_compress.TopKCodec(k)
    arrays, meta = codec.encode_adapter(_t(adapter))
    back = codec.decode_adapter(arrays, meta)
    order = [perm.index(j) for j in range(4)]     # by decreasing energy
    assert meta["q"]["keep"] == sorted(order[:k])
    for t, ad in adapter.items():
        keep = meta[t]["keep"]
        drop = [j for j in range(4) if j not in keep]
        np.testing.assert_array_equal(back[t]["A"][..., keep].numpy(),
                                      ad["A"][..., keep])
        assert not back[t]["A"][..., drop].any()
        assert not back[t]["B"][..., drop, :].any()


@settings(deadline=None, max_examples=10)
@given(seed=st.integers(0, 10_000), r=st.integers(1, 8))
def test_bf16_bytes_equal_reference(seed, r):
    """Round to nearest even, as ``jnp.astype``; relative error ≤ 2⁻⁸."""
    adapter = _adapter(seed, r=r)
    _hold_same_messages(adapter, _head(seed), "bf16")
    codec = t_compress.Bf16Codec()
    arrays, meta = codec.encode_adapter(_t(adapter))
    assert meta == {"targets": ["q", "v"]}
    back = codec.decode_adapter(arrays, meta)
    for t, ad in adapter.items():
        for leaf in ("A", "B"):
            assert arrays[f"{t}/{leaf}"].dtype == torch.bfloat16
            err = np.abs(back[t][leaf].numpy() - ad[leaf])
            assert (err <= 2.0 ** -8 * np.abs(ad[leaf])).all()


def test_codec_from_name_resolution_equals_reference():
    for spec in (None, "", "none", " NONE ", "bf16", "int8", "topk",
                 "topk:3", "TopK:12"):
        want, got = j_compress.from_name(spec), t_compress.from_name(spec)
        assert (got is None) == (want is None), spec
        if want is not None:
            assert got.name == want.name
            assert getattr(got, "k", None) == getattr(want, "k", None)
    codec = t_compress.Int8Codec()
    assert t_compress.codec_from_name(codec) is codec
    for bad in ("gzip", "topk:x"):
        with pytest.raises(ValueError):
            t_compress.from_name(bad)
    with pytest.raises(ValueError, match="k >= 1"):
        t_compress.TopKCodec(0)
    with pytest.raises(ValueError, match="unknown wire codec"):
        t_compress.decoder_for("zstd")
    for name in ("bf16", "int8", "topk"):
        assert t_compress.decoder_for(name).name == name


def test_no_codec_is_the_raw_format():
    """``codec=None`` and ``"none"`` give the codec-less bytes, which carry
    no codec entry in the header."""
    adapter, head = _adapter(1), _head(1)
    raw = t_msg.ClientUpdate(client_id=0, start_version=0, num_examples=1,
                             adapter=_t(adapter), head=_t(head))
    none = t_msg.ClientUpdate(client_id=0, start_version=0, num_examples=1,
                              adapter=_t(adapter), head=_t(head),
                              codec=t_compress.from_name("none"))
    assert raw.to_bytes() == none.to_bytes() == j_msg.ClientUpdate(
        client_id=0, start_version=0, num_examples=1, adapter=adapter,
        head=head).to_bytes()
    _, meta, _ = t_msg.unpack_wire(raw.to_bytes())
    assert "codec" not in meta


@pytest.mark.parametrize("codec", ["int8", "topk:2", "bf16"])
def test_encoded_payload_shrinks_the_message(codec):
    """Measured bytes: int8 and topk at half the rank come in under the
    raw float32 message, bf16 at about half of it."""
    adapter = _adapter(4, layers=2, d_in=64, d_out=64, r=4)
    raw = t_msg.Broadcast(version=0, client_id=0, adapter=_t(adapter))
    enc = t_msg.Broadcast(version=0, client_id=0, adapter=_t(adapter),
                          codec=t_compress.from_name(codec))
    assert enc.num_bytes < 0.6 * raw.num_bytes
    assert t_msg.payload_bytes(enc) == t_msg.payload_bytes(raw)


# ---------------------------------------------------------------------------
# the session's codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("where", ["config", "argument"])
def test_session_codec_messages_match_reference(weights, codec, where):
    """A session with a codec (from ``ServerConfig.codec`` or
    ``FedSession(codec=)``): every broadcast's bytes, the comm log and
    the collected (decoded) stack equal the reference's, from one
    trained-looking global adapter."""
    server = dict(SERVER, strategy="hlora")
    cfg_kw = dict(codec=codec) if where == "config" else {}
    arg_kw = dict(codec=codec) if where == "argument" else {}
    j = j_session.FedSession(weights["jcfg"], j_session.ServerConfig(
        **server, **cfg_kw), weights["jparams"], **arg_kw)
    t = t_session.FedSession(weights["tcfg"], t_session.ServerConfig(
        **server, **cfg_kw), weights["tparams"], device="cpu", **arg_kw)
    assert t.codec.name == j.codec.name
    rng = np.random.default_rng(5)
    lora = _initial_lora(weights, SERVER)
    for ad in lora.values():
        ad["B"] = (0.05 * rng.standard_normal(ad["B"].shape)).astype(
            np.float32)
    import jax
    j.global_lora = jax.tree.map(jnp.asarray, lora)
    from repro_torch import interop
    t.global_lora = interop.lora_from_jax(lora, "cpu")
    cohort = np.array([0, 3, 5])
    jtree, jheads = j.broadcast_cohort(cohort)
    ttree, theads = t.broadcast_cohort(cohort)
    assert t.comm_log == j.comm_log
    for tt in jtree:
        for leaf in ("A", "B", "mask"):
            np.testing.assert_array_equal(_numpy(ttree)[tt][leaf],
                                          np.asarray(jtree[tt][leaf]))
    jc, jh = j.collect_updates(cohort, jtree, jheads)
    tc, th = t.collect_updates(cohort, ttree, theads)
    assert t.comm_log == j.comm_log
    for tt in jc:
        for leaf in ("A", "B", "mask"):
            np.testing.assert_array_equal(_numpy(tc)[tt][leaf],
                                          np.asarray(jc[tt][leaf]))
    for k in jh:
        np.testing.assert_array_equal(th[k].numpy(), np.asarray(jh[k]))


def test_buffered_async_with_a_codec_matches_reference(weights):
    """``run_experiment(scheduler=BufferedAsync(...))`` with
    ``ServerConfig(codec="int8")``: SIM's 9 events merged 2 at a time. The
    port's run is anchored (each trained update held to the reference's
    and replaced by it, the reference's state put back after each flush),
    so every broadcast and update is encoded from the same arrays: the
    byte columns, events, staleness and flags equal, every update and
    flush within ``tests/test_torch_async.py``'s limits."""
    server = dict(SERVER, codec="int8")

    def run(pkg, initial=None, anchors=None):
        mod_sched, mod_sim, mod_sess = (
            (j_sched, j_sim, j_session) if pkg == "reference"
            else (t_sched, t_sim, t_session))
        sched = _recording(
            mod_sched.BufferedAsync, initial, anchors, _holder(weights),
            speeds=np.linspace(0.5, 2.0, SERVER["num_clients"]),
            buffer_size=2, acfg=mod_sess.AsyncConfig(base_weight=0.5))
        kw = dict(engine=j_engine.AggregationEngine(use_pallas=False)) \
            if pkg == "reference" else dict(device="cpu")
        hist = mod_sim.run_experiment(
            weights["jcfg" if pkg == "reference" else "tcfg"],
            mod_sim.SimConfig(**SIM), mod_sess.ServerConfig(**server),
            base_params=weights["jparams" if pkg == "reference"
                                else "tparams"], scheduler=sched, **kw)
        return sched, hist

    jsched, jhist = run("reference")
    asched, ahist = run("port", _initial_lora(weights, SERVER), jsched.log)
    _hold_async(jsched, jhist, asched, ahist)
    assert asched.session.codec.name == "int8"
    assert ahist["flush_events"] == [2, 2, 2, 2, 1]
    assert asched.session.comm_totals() == jsched.session.comm_totals()


def test_midflight_checkpoint_keeps_codec_bytes(weights, tmp_path):
    """A ``BufferedAsync`` run with an int8 codec saved with updates in its
    buffer: the restored buffer holds the same encoded bytes and decodes
    to the same bits, and the resumed run keeps the uninterrupted run's
    events and staleness. (Its floats differ from the uninterrupted run's,
    as the reference's do: a live buffer merges the trained factors, a
    restored one what the int8 bytes decode to.)"""
    from repro_torch.fed.client import make_local_train
    from repro_torch.optim import adamw
    from repro_torch.data import client_batches, make_pair_classification

    cfg = weights["tcfg"]
    scfg = t_session.ServerConfig(**dict(SERVER, codec="int8"))
    tokens, labels = make_pair_classification("mrpc", 96, seed=0,
                                              vocab_size=cfg.vocab_size)
    shards = np.array_split(np.arange(96), SERVER["num_clients"])
    local = make_local_train(cfg, adamw(1e-3), device="cpu")

    def data_fn():
        calls = {}

        def fn(cid):
            n = calls[cid] = calls.get(cid, 0) + 1
            return client_batches(tokens, labels, shards[cid], 1, 4,
                                  seed=100 * n + cid)
        return fn

    def sched():
        return t_sched.BufferedAsync(
            speeds=np.linspace(0.5, 2.0, SERVER["num_clients"]),
            buffer_size=3, drain=False)

    straight = t_session.FedSession(cfg, scfg, weights["tparams"],
                                    device="cpu")
    fn = data_fn()
    sched().run(straight, local, fn, 7)
    split = t_session.FedSession(cfg, scfg, weights["tparams"],
                                 device="cpu")
    fn2 = data_fn()
    sched().run(split, local, fn2, 5)
    buffered = [u.to_bytes() for u in split.async_state["buffer"]]
    assert buffered and all(b"int8" in b[:400] for b in buffered)
    split.save(str(tmp_path))
    resumed = t_session.FedSession.restore(str(tmp_path), cfg, scfg,
                                           weights["tparams"], device="cpu")
    restored = resumed.async_state["buffer"]
    assert [u.to_bytes() for u in restored] == buffered
    for u, data in zip(restored, buffered):
        again = t_msg.ClientUpdate.from_bytes(data)
        for t in u.adapter:
            for leaf in ("A", "B"):
                assert torch.equal(u.adapter[t][leaf], again.adapter[t][leaf])
    sched().run(resumed, local, fn2, 2)
    assert resumed.staleness_log == straight.staleness_log
    assert resumed.version == straight.version
    assert [h[:2] for h in resumed.async_state["heap"]] == \
        [h[:2] for h in straight.async_state["heap"]]
