"""The port's round pieces without a session, against the reference's, on
the CPU: ``core/seeds.py``, ``core/rank.py``, ``fed/strategies.py`` and
``fed/messages.py``.

Seeds and ranks are integers and must be equal. Strategies are
declarative and must carry the same fields. Messages must be the same
bytes for the same arrays (the reference's numpy arrays, the port's
tensors made from them, bfloat16 from the same bit patterns), round trips
exact, and truncation then padding bit-exact on masked factors.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rank as j_rank
from repro.core import seeds as j_seeds
from repro.fed import compress as j_compress
from repro.fed import messages as j_msg
from repro.fed import session as j_session
from repro.fed import strategies as j_strat
from repro_torch.core import rank as t_rank
from repro_torch.core import seeds as t_seeds
from repro_torch.fed import compress as t_compress
from repro_torch.fed import messages as t_msg
from repro_torch.fed import session as t_session
from repro_torch.fed import strategies as t_strat


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# seeds and rank policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2 ** 31 - 1, 2 ** 40])
def test_derive_seed_equals_reference(seed):
    for purpose in ("", "async-client-batches", "pretrain-batches",
                    "ünïcode", "a" * 200):
        want = j_seeds.derive_seed(seed, purpose)
        got = t_seeds.derive_seed(seed, purpose)
        assert got == want and type(got) is int
        torch.Generator().manual_seed(got)          # fits a torch seed


@pytest.mark.parametrize("n,r_min,r_max", [(1, 2, 8), (16, 2, 8),
                                           (100, 1, 64), (7, 4, 4)])
def test_rank_policies_equal_reference(n, r_min, r_max):
    rng = np.random.default_rng(n * 31 + r_max)
    for seed in (0, 3, 99):
        np.testing.assert_array_equal(
            t_rank.random_ranks(n, r_min, r_max, seed),
            j_rank.random_ranks(n, r_min, r_max, seed))
    np.testing.assert_array_equal(t_rank.uniform_ranks(n, r_max),
                                  j_rank.uniform_ranks(n, r_max))
    caps = rng.random(n)
    for c in (caps, np.ones(n), np.round(caps * 4)):
        np.testing.assert_array_equal(
            t_rank.capacity_ranks(c, r_min, r_max),
            j_rank.capacity_ranks(c, r_min, r_max))
    sizes = rng.integers(2, 5000, size=n)
    np.testing.assert_array_equal(t_rank.data_ranks(sizes, r_min, r_max),
                                  j_rank.data_ranks(sizes, r_min, r_max))
    sig = np.sort(rng.random(r_max) ** 3)[::-1]
    for energy in (0.5, 0.9, 0.95, 0.999):
        for c in (None, caps):
            want = j_rank.spectrum_ranks(sig, n, r_min, r_max, energy, c)
            got = t_rank.spectrum_ranks(sig, n, r_min, r_max, energy, c)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype == np.int32
    for name in ("uniform", "random", "capacity", "data", "spectrum"):
        assert t_rank.get_policy(name).__name__ == \
            j_rank.get_policy(name).__name__
    with pytest.raises(KeyError):
        t_rank.get_policy("nope")


@pytest.mark.parametrize("policy", ["uniform", "random", "capacity", "data",
                                    "spectrum"])
def test_assign_ranks_equals_reference(policy):
    sizes = [5, 300, 41, 1000, 77, 2]
    for seed in (0, 5):
        kw = dict(num_clients=6, rank_policy=policy, seed=seed)
        want = j_session.assign_ranks(j_session.ServerConfig(**kw), sizes,
                                      rng=np.random.default_rng(seed + 1))
        got = t_session.assign_ranks(t_session.ServerConfig(**kw), sizes,
                                     rng=np.random.default_rng(seed + 1))
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        t_session.assign_ranks(t_session.ServerConfig(rank_policy="x"), sizes)


def test_server_config_fields_equal_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(
        t_session.ServerConfig)] == [(f.name, f.default) for f in
                                     dataclasses.fields(
                                         j_session.ServerConfig)]


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["naive", "hlora", "flora"])
def test_strategies_equal_reference(name):
    for method, split in (("factored", "paper"), ("exact", "sqrt"),
                          ("randomized", "paper")):
        jc = j_session.ServerConfig(svd_method=method, split=split)
        tc = t_session.ServerConfig(svd_method=method, split=split)
        want, got = j_strat.from_name(name), t_strat.from_name(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        want, got = j_strat.from_name(name, jc), t_strat.from_name(name, tc)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.engine_kwargs() == want.engine_kwargs()
        assert type(got).__name__ == type(want).__name__


def test_register_strategy_and_reserved_names():
    for name in ("naive", "hlora", "flora"):
        with pytest.raises(ValueError, match="built-in"):
            t_strat.register_strategy(t_strat.AggregationStrategy(name=name))
    with pytest.raises(ValueError, match="unknown aggregation strategy "
                       "'nope'; known: naive, hlora, flora") as err:
        t_strat.from_name("nope")
    with pytest.raises(ValueError) as jerr:
        j_strat.from_name("nope")
    assert str(err.value) == str(jerr.value)
    custom = t_strat.AggregationStrategy(name="test-torch-fed-custom",
                                         method="exact", split="sqrt",
                                         scale_correction=True)
    try:
        assert t_strat.register_strategy(custom) is custom
        assert t_strat.from_name("test-torch-fed-custom") is custom
        assert custom.engine_kwargs() == {"strategy": "hlora",
                                          "method": "exact", "split": "sqrt"}
        with pytest.raises(ValueError, match="test-torch-fed-custom"):
            t_strat.from_name("nope")
    finally:
        t_strat._REGISTRY.pop("test-torch-fed-custom", None)
    with pytest.raises(dataclasses.FrozenInstanceError):
        custom.name = "other"


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------

def _bf16(a: np.ndarray):
    """(the reference's bfloat16 numpy array, the port's tensor with the
    same bit patterns)."""
    j = np.asarray(a, np.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(j.view(np.int16).copy()).view(torch.bfloat16)
    return j, t


def _arrays(seed):
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 5, 4)).astype(np.float32)
    i32 = rng.integers(-9, 9, size=(7,)).astype(np.int32)
    zero_d = np.asarray(rng.standard_normal(), np.float32)
    j_bf, t_bf = _bf16(rng.standard_normal((2, 6)))
    j_bf0, t_bf0 = _bf16(np.float32(1.5))
    empty = np.zeros((0, 3), np.float32)
    want = {"b/f32": f32, "a/i32": i32, "z/scalar": zero_d, "m/bf16": j_bf,
            "m/bf16_0d": j_bf0, "e/empty": empty}
    got = {"b/f32": torch.from_numpy(f32), "a/i32": torch.from_numpy(i32),
           "z/scalar": torch.from_numpy(zero_d.copy()), "m/bf16": t_bf,
           "m/bf16_0d": t_bf0, "e/empty": torch.from_numpy(empty)}
    return want, got


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_wire_bytes_equal_reference_and_round_trip(seed):
    want, got = _arrays(seed)
    meta = {"version": 3, "client_id": seed, "x": [1, 2.5, "s"]}
    data = t_msg.pack_wire("update", meta, got)
    assert data == j_msg.pack_wire("update", meta, want)
    kind, m, arrays = t_msg.unpack_wire(data)
    assert kind == "update" and m == meta
    assert list(arrays) == sorted(got)
    for path, t in got.items():
        assert arrays[path].dtype == t.dtype
        assert arrays[path].shape == t.shape
        np.testing.assert_array_equal(_bits(arrays[path]), _bits(t))
    with pytest.raises(ValueError, match="wire version"):
        t_msg.unpack_wire(data.replace(b'"wire": 1', b'"wire": 2', 1))


def _adapter(seed, ranks, stack=(2,), d_in=12, d_out=10, r_max=8,
             dtype=np.float32):
    """Masked factors (A m, B m) per target, numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for t, r in ranks.items():
        m = (np.arange(r_max) < r).astype(np.float32)
        a = rng.standard_normal((*stack, d_in, r_max)) * m[:, None].T
        b = rng.standard_normal((*stack, r_max, d_out)) * m[:, None]
        out[t] = {"A": a.astype(dtype), "B": b.astype(dtype),
                  "mask": np.broadcast_to(m, (*stack, r_max)).copy()}
    return out


def _t_tree(tree):
    return {t: {k: torch.from_numpy(np.array(v)) for k, v in ad.items()}
            for t, ad in tree.items()}


@pytest.mark.parametrize("ranks", [{"q": 3, "v": 8}, {"q": 1, "v": 1},
                                   {"q": 8, "w2": 5}])
def test_messages_bytes_equal_reference(ranks):
    tree = _adapter(7, ranks)
    head = {"cls_head": np.random.default_rng(0).standard_normal(
        (10, 2)).astype(np.float32), "cls_bias": np.zeros(2, np.float32)}
    thead = {k: torch.from_numpy(v) for k, v in head.items()}
    jpay = j_msg.truncate_adapter(tree, ranks)
    tpay = t_msg.truncate_adapter(_t_tree(tree), ranks)
    jb = j_msg.Broadcast(version=2, client_id=5, adapter=jpay, head=head)
    tb = t_msg.Broadcast(version=2, client_id=5, adapter=tpay, head=thead)
    assert tb.to_bytes() == jb.to_bytes()
    assert tb.num_bytes == jb.num_bytes == len(tb.to_bytes())
    assert t_msg.payload_bytes(tb) == j_msg.payload_bytes(jb)
    hlen = int.from_bytes(tb.to_bytes()[:4], "little")
    assert tb.num_bytes == 4 + hlen + t_msg.payload_bytes(tb)
    ju = j_msg.ClientUpdate(client_id=5, start_version=1, num_examples=321,
                            adapter=jpay, head=head)
    tu = t_msg.ClientUpdate(client_id=5, start_version=1, num_examples=321,
                            adapter=tpay, head=thead)
    assert tu.to_bytes() == ju.to_bytes()
    assert t_msg.payload_bytes(tu) == j_msg.payload_bytes(ju)
    # the port reads the reference's bytes and unpacks what it unpacks
    back = t_msg.ClientUpdate.from_bytes(ju.to_bytes())
    assert (back.client_id, back.start_version, back.num_examples) == \
        (5, 1, 321)
    tree_t, head_t = back.unpack(8, "cpu")
    tree_j, head_j = j_msg.ClientUpdate.from_bytes(ju.to_bytes()).unpack(8)
    for t in tree_j:
        for leaf in ("A", "B", "mask"):
            got, want = tree_t[t][leaf].numpy(), np.asarray(tree_j[t][leaf])
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for k in head_j:
        np.testing.assert_array_equal(head_t[k].numpy(), head_j[k])
    with pytest.raises(ValueError, match="expected 'broadcast'"):
        t_msg.Broadcast.from_bytes(tu.to_bytes())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_truncate_then_pad_is_bit_exact_on_masked_factors(dtype):
    ranks = {"q": 2, "v": 6}
    tree = _t_tree(_adapter(11, ranks, stack=(3,)))
    if dtype == "bfloat16":
        tree = {t: {k: (v.to(torch.bfloat16) if k != "mask" else v)
                    for k, v in ad.items()} for t, ad in tree.items()}
    msg = t_msg.Broadcast(version=0, client_id=1,
                          adapter=t_msg.truncate_adapter(tree, ranks))
    wire = t_msg.Broadcast.from_bytes(msg.to_bytes())
    for t in ranks:
        for leaf in ("A", "B"):
            np.testing.assert_array_equal(_bits(wire.adapter[t][leaf]),
                                          _bits(msg.adapter[t][leaf]))
    padded, head = wire.unpack(8, "cpu")
    assert head == {}
    for t, ad in tree.items():
        for leaf in ("A", "B", "mask"):
            assert padded[t][leaf].dtype == ad[leaf].dtype
            # masked directions are +0.0 after padding; A m may hold -0.0
            assert torch.equal(padded[t][leaf], ad[leaf]), (t, leaf)
    if dtype == "bfloat16":
        jtree = {t: {"A": _bf16(ad["A"].float().numpy())[0],
                     "B": _bf16(ad["B"].float().numpy())[0]}
                 for t, ad in tree.items()}
        jmsg = j_msg.Broadcast(version=0, client_id=1,
                               adapter=j_msg.truncate_adapter(jtree, ranks))
        assert msg.to_bytes() == jmsg.to_bytes()
        assert t_msg.payload_bytes(msg) == j_msg.payload_bytes(jmsg)


def test_codecs_are_refused():
    """Nothing of the codec path is refused any more: the reference's int8
    ``ClientUpdate`` decodes in the port to the reference's own decoded
    bits, re-encodes to the same bytes, and a port message with a codec
    object that is not a ``WireCodec`` is the caller's error at encode
    time, not a refusal at construction."""
    tree = _adapter(3, {"q": 4})
    head = {"cls_bias": np.asarray([0.25, -1.5], np.float32)}
    pay = j_msg.truncate_adapter(tree, {"q": 4})
    tpay = t_msg.truncate_adapter(_t_tree(tree), {"q": 4})
    encoded = j_msg.ClientUpdate(client_id=0, start_version=0,
                                 num_examples=1, adapter=pay, head=head,
                                 codec=j_compress.from_name("int8"))
    got = t_msg.ClientUpdate.from_bytes(encoded.to_bytes())
    want = j_msg.ClientUpdate.from_bytes(encoded.to_bytes())
    for leaf in ("A", "B"):
        assert got.adapter["q"][leaf].dtype == torch.float32
        np.testing.assert_array_equal(got.adapter["q"][leaf].numpy(),
                                      want.adapter["q"][leaf])
    np.testing.assert_array_equal(got.head["cls_bias"].numpy(),
                                  head["cls_bias"])
    mine = t_msg.ClientUpdate(client_id=0, start_version=0, num_examples=1,
                              adapter=tpay, head={k: torch.from_numpy(v)
                                                  for k, v in head.items()},
                              codec=t_compress.from_name("int8"))
    assert mine.to_bytes() == encoded.to_bytes()
    odd = t_msg.ClientUpdate(client_id=0, start_version=0, num_examples=1,
                             adapter=tpay, codec=object())
    with pytest.raises(AttributeError):
        odd.to_bytes()
