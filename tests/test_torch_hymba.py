"""The port's Hymba hybrid family against the reference's, on the CPU.

``repro_torch.models.hymba`` (``hybrid_layer``: attention and the Mamba2
mixer in parallel on one normed input; ``forward``; the nested decode
cache, a windowed ring beside the SSD state) and the ``hybrid`` branches of
``repro_torch.models.model`` against ``repro.models.hymba`` and
``repro.models.model``, at ``hymba-reduced`` (2 layers, d_model 128, 4
heads of 32 with 2 KV heads, d_inner 256 in 8 SSD heads of 32, state 16,
a 64-token window). Inputs come from numpy seeds; models start from the
reference's own seed-0 weights carried over by ``repro_torch.interop``,
with live adapters (small random B) at heterogeneous ranks on all six
targets.

Sequences run past the window: the model's 256 tokens are four windows
and two SSD chunks of 128; decode runs 160 tokens, so the 64-slot ring
wraps twice.

Tolerances, float32 throughout (values O(1)):
- the layer, the logits and the loss: rtol 1e-5, atol 1e-5 of the largest
  magnitude (``CLOSE``), as in ``tests/test_torch_mamba2.py``: the same
  float32 products summed in another order;
- every gradient against ``jax.vjp`` of the reference's ``loss_fn``,
  normwise ``GRAD_REL`` (1e-5) of the reference's, except ``A_log``, held by
  name to ``A_LOG_REL`` (1e-4): its gradient sums decay derivatives that
  nearly cancel, as ``tests/test_torch_mamba2.py`` sets out;
- decode against the reference's decode and against the port's forward:
  ``DECODE_REL`` (1e-5) of the logits' largest magnitude, far inside the
  reference test's 2e-3 (``tests/test_models.py``); the control without
  the window must miss the same limit;
- the trainers: ``tests/test_torch_train.py``'s forward (rtol 1e-4, atol
  1e-5) and trained-factor (normwise 1e-3 of the change the steps made)
  tolerances; the merge: ``tests/test_torch_aggregate.py``'s (every
  client's effective update normwise 1e-4, spectra rtol 1e-4);
- ``remat`` within the port: the same bits.
"""
import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.core import agg_engine as j_engine
from repro.fed import client as j_client
from repro.models import hymba as j_hymba
from repro.models import model as j_model
from repro.models import transformer as j_tf
from repro.optim import optimizers as j_opt
from repro_torch import interop
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import agg_engine as t_engine
from repro_torch.data import make_bigram_lm
from repro_torch.fed import (make_cohort_train, make_local_train,
                             simulation as t_sim, split_adapters, split_head)
from repro_torch.models import hymba as t_hymba
from repro_torch.models import mamba2 as t_ssm
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_tf
from repro_torch.optim import optimizers as t_opt
from test_torch_aggregate import ALPHA, _assert_hlora_close
from test_torch_lm import (_example, _flat_np,
                           _hold_train_against_reference_example, _t)

ARCH = "hymba-1.5b"
CLOSE = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-5
A_LOG_REL = 1e-4
DECODE_REL = 1e-5
FWD = dict(rtol=1e-4, atol=1e-5)
LR = 1e-3
TRAINED_REL = 1e-3
MERGE_REL = 1e-4
SEQ = 256             # four 64-token windows, two SSD chunks of 128
DECODE_SEQ = 160      # the 64-slot ring wraps twice
TRAIN_SEQ = 128       # past the window, one SSD chunk
RANKS = {"q": 3, "k": 5, "v": 8, "o": 2, "ssm_in": 4, "ssm_out": 6}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread avoids thread-pool
    overhead and contention with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    """|got - want| <= rtol |want| + atol max|want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol["rtol"],
                               atol=tol["atol"] * max(np.abs(want).max(),
                                                      1e-30),
                               err_msg=what)


def _masks(cfg, ranks, seed=5):
    """{target: (L, r_max) mask}: the target's rank, each kept direction
    scaled as a trained mask would be."""
    rng = np.random.default_rng(seed)
    out = {}
    for t, r in ranks.items():
        m = (np.arange(cfg.lora.r_max) < r).astype(np.float32)
        out[t] = np.broadcast_to(m * rng.uniform(0.8, 1.2, m.shape),
                                 (cfg.num_layers, cfg.lora.r_max)).astype(
            np.float32)
    return out


def _tree(seed=0, ranks=None):
    """The reference's seed-``seed`` weights as numpy, with live adapters
    (B small and random) at ``ranks`` ({target: rank}; None: r_max)."""
    jcfg = j_get_reduced(ARCH)
    tree = jax.tree.map(np.array, j_model.init_params(
        jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 3)
    r = jcfg.lora.r_max
    masks = _masks(jcfg, ranks or {t: r for t in jcfg.lora.targets})
    for t, ad in tree["lora"].items():
        ad["B"] = (0.05 * rng.standard_normal(ad["B"].shape)).astype(
            np.float32)
        ad["mask"] = masks[t]
    return tree


@pytest.fixture(scope="module")
def cfgs():
    return j_get_reduced(ARCH), get_reduced(ARCH)


@pytest.fixture(scope="module")
def tree():
    return _tree(ranks=RANKS)


def _tokens(cfg, rows=2, seq=SEQ, seed=9):
    return make_bigram_lm(rows, seq, cfg.vocab_size, seed=seed)


def _batch(cfg, rows=2, seq=SEQ, seed=9):
    data = _tokens(cfg, rows, seq, seed)
    labels = data["labels"].copy()
    labels[:, -2:] = -1                 # a few positions not scored
    return {"tokens": data["tokens"], "labels": labels}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_match_reference():
    """``CONFIG``, ``reduced()``, their derived widths, ``param_count`` and
    the six LoRA targets' shapes, field for field against the
    reference's."""
    fields = ("name", "arch_type", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "head_dim", "resolved_head_dim", "d_ff",
              "vocab_size", "ssm_state", "ssm_expand", "ssm_head_dim",
              "ssm_conv_width", "sliding_window", "rope_theta", "activation",
              "tie_embeddings", "use_bias", "source", "d_inner", "ssm_heads",
              "is_attention_free")
    targets = ("q", "k", "v", "o", "ssm_in", "ssm_out")
    for jc, tc in ((j_get_config(ARCH), get_config(ARCH)),
                   (j_get_reduced(ARCH), get_reduced(ARCH))):
        for f in fields:
            assert getattr(jc, f) == getattr(tc, f), f
        assert jc.lora.targets == tc.lora.targets == targets
        assert (jc.lora.r_max, jc.lora.alpha) == (tc.lora.r_max,
                                                  tc.lora.alpha)
        assert jc.param_count() == tc.param_count()
        assert j_tf.lora_specs(jc) == t_tf.lora_specs(tc)
    full = get_config(ARCH)
    assert full.param_count() == 1_640_144_000
    assert (full.d_inner, full.ssm_heads) == (3200, 50)
    assert t_tf.lora_specs(full) == {
        "q": (1600, 1600), "k": (1600, 320), "v": (1600, 320),
        "o": (1600, 1600), "ssm_in": (1600, 6482), "ssm_out": (3200, 1600)}


# ---------------------------------------------------------------------------
# init, the layer, the forward, the loss and its gradients
# ---------------------------------------------------------------------------

def test_init_params_and_init_cache_shapes_and_dtypes(cfgs):
    """The port's own init has the reference's leaves, shapes and dtypes
    (the SSM scalars float32 under a bf16 model), the ssm group after the
    transformer's four;
    ``init_cache`` nests the ring ({"k", "v", "pos"} at the window's 64
    slots) and the SSD cache ({"conv", "state"}) with the reference's
    shapes and dtypes, the conv window in the cache's dtype, the state
    float32, every slot empty (-1)."""
    jcfg, tcfg = cfgs
    jtree = jax.tree.map(np.asarray, j_model.init_params(
        jax.random.PRNGKey(0), jcfg))
    p = t_model.init_params(tcfg, seed=0, device="cpu")
    got, want = _flat_np(p.tree()), _flat_np(jtree)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].shape == w.shape and got[path].dtype == w.dtype, path
    assert p.groups == ("ln1", "attn", "ln2", "mlp", "ssm")
    assert p.lm_head is not None
    for name, std in (("in_proj", tcfg.d_model ** -0.5),
                      ("out_proj", tcfg.d_inner ** -0.5)):
        got_std = float(getattr(p.layers["ssm"], name).std())
        assert abs(got_std / std - 1.0) < 0.05, name
    # the ssm weights are their own draws, not a copy of attention's
    assert not torch.equal(p.layers["ssm"].in_proj[:, :, :16],
                           p.layers["attn"].wq[:, :, :16])
    bf = t_model.init_params(tcfg, seed=0, dtype=torch.bfloat16,
                             device="cpu")
    for name in t_ssm.FLOAT32_LEAVES:
        assert getattr(bf.layers["ssm"], name).dtype == torch.float32
    assert bf.layers["attn"].wq.dtype == torch.bfloat16
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        tc = t_model.init_cache(tcfg, 3, DECODE_SEQ, dtype, device="cpu")
        jc = j_model.init_cache(jcfg, 3, DECODE_SEQ, jdtype)
        assert sorted(tc) == sorted(jc) == ["kv", "ssm"]
        assert sorted(tc["kv"]) == sorted(jc["kv"]) == ["k", "pos", "v"]
        assert sorted(tc["ssm"]) == sorted(jc["ssm"]) == ["conv", "state"]
        for part in ("kv", "ssm"):
            for k in tc[part]:
                assert tuple(tc[part][k].shape) == jc[part][k].shape, k
                assert (str(tc[part][k].dtype).split(".")[1]
                        == str(jc[part][k].dtype)), k
        assert bool((tc["kv"]["pos"] == -1).all())
    L, w = tcfg.num_layers, tcfg.sliding_window
    assert tc["kv"]["k"].shape == (L, 3, w, tcfg.num_kv_heads,
                                   tcfg.resolved_head_dim)
    assert tc["ssm"]["state"].shape == (L, 3, tcfg.ssm_heads,
                                        tcfg.ssm_head_dim, tcfg.ssm_state)
    short = t_model.init_cache(tcfg, 1, 40, device="cpu")
    assert short["kv"]["k"].shape[2] == 40          # min(window, max_seq)


def test_hybrid_layer_matches_reference(cfgs, tree):
    """Layer 0 on 2 x 256 tokens with live adapters on all six targets
    against the reference's ``hybrid_layer``; each branch's adapters act."""
    jcfg, tcfg = cfgs
    x = (0.5 * np.random.default_rng(4).standard_normal(
        (2, SEQ, tcfg.d_model))).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], tree["layers"])
    ad = jax.tree.map(lambda a: a[0], tree["lora"])
    pos = np.arange(SEQ)[None, :]
    yj, auxj = j_hymba.hybrid_layer(
        jnp.asarray(x), jax.tree.map(jnp.asarray, lp),
        jax.tree.map(jnp.asarray, ad), jcfg, positions=jnp.asarray(pos),
        q_chunk=64)
    tlp = interop.tree_from_numpy(lp, "cpu")
    tad = interop.tree_from_numpy(ad, "cpu")
    with torch.no_grad():
        yt, auxt = t_hymba.hybrid_layer(_t(x), tlp, tad, tcfg,
                                        positions=_t(pos), q_chunk=64)
        for drop in (("q", "k", "v", "o"), ("ssm_in", "ssm_out")):
            part = {t: a for t, a in tad.items() if t not in drop}
            other, _ = t_hymba.hybrid_layer(_t(x), tlp, part, tcfg,
                                            positions=_t(pos), q_chunk=64)
            assert float((other - yt).abs().max()) > 1e-4, drop
    _close(yt.numpy(), yj, CLOSE, "hybrid_layer")
    assert auxt.dtype == torch.float32 and float(auxt) == float(auxj) == 0.0


@pytest.mark.parametrize("remat", [False, True])
def test_forward_and_loss_match_reference(cfgs, tree, remat):
    """The logits over 2 x 256 tokens (the window cuts the attention of
    every query past 64) and the LM loss with its metrics (aux a float32
    zero) against the reference's ``forward`` and ``loss_fn``."""
    jcfg, tcfg = cfgs
    batch = _batch(tcfg)
    jt = jax.tree.map(jnp.asarray, tree)
    jl, jaux = j_model.forward(jt, {"tokens": jnp.asarray(batch["tokens"])},
                               jcfg, remat=remat)
    total_j, m_j = j_model.loss_fn(jt, jax.tree.map(jnp.asarray, batch),
                                   jcfg, remat=remat)
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = t_model.forward(params, tb, tcfg, remat=remat)
        total_t, m_t = t_model.loss_fn(params, tb, tcfg, remat=remat)
    _close(logits.numpy(), jl, CLOSE, "logits")
    assert aux.dtype == torch.float32 and float(aux) == float(jaux) == 0.0
    assert sorted(m_t) == sorted(m_j) == ["aux", "loss", "nll"]
    np.testing.assert_allclose(float(total_t), float(total_j), rtol=1e-5)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5,
                                   err_msg=k)


def _vjp_grads(jcfg, tree, batch, remat, lora_only):
    """``jax.vjp`` of the reference's ``loss_fn`` at cotangent 1, jitted,
    with respect to every leaf or to the adapters alone."""
    def run(jt, jb):
        if lora_only:
            def f(lora):
                return j_model.loss_fn({**jt, "lora": lora}, jb, jcfg,
                                       remat=remat)[0]
            primal = jt["lora"]
        else:
            def f(params):
                return j_model.loss_fn(params, jb, jcfg, remat=remat)[0]
            primal = jt
        loss, vjp = jax.vjp(f, primal)
        return loss, vjp(jnp.ones((), jnp.float32))[0]

    loss, grads = jax.jit(run)(jax.tree.map(jnp.asarray, tree),
                               jax.tree.map(jnp.asarray, batch))
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("mode", ["backbone", "lora"])
def test_every_gradient_matches_jax_vjp(cfgs, tree, mode, remat):
    """Backbone mode (``pretrain_loss_and_grads``: every leaf, the
    embedding, norms, attention, every ssm weight, the MLP, ``lm_head`` and
    the adapters) and LoRA mode (the six targets' A, B and masks over the
    frozen model) against ``jax.vjp`` of the reference's loss, normwise;
    ``A_log`` alone by name at ``A_LOG_REL``."""
    jcfg, tcfg = cfgs
    batch = _batch(tcfg)
    lora_only = mode == "lora"
    loss_j, grads_j = _vjp_grads(jcfg, tree, batch, remat, lora_only)
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    tb = {k: _t(v) for k, v in batch.items()}
    if lora_only:
        p = copy.copy(params)
        p.lora = {t: {k: v.clone().requires_grad_(True) for k, v in
                      ad.items()} for t, ad in params.lora.items()}
        loss_t, _ = t_model.loss_fn(p, tb, tcfg, remat=remat)
        paths = [(t, k) for t in sorted(p.lora) for k in sorted(p.lora[t])]
        gs = torch.autograd.grad(loss_t, [p.lora[t][k] for t, k in paths])
        got = {path: g.numpy() for path, g in zip(paths, gs)}
    else:
        loss_t, grads_t = t_sim.pretrain_loss_and_grads(
            params.tree(), tb, tcfg, remat=remat)
        got = _flat_np(grads_t)
    np.testing.assert_allclose(float(loss_t.detach()), loss_j, rtol=1e-5)
    want = _flat_np(grads_j)
    assert sorted(got) == sorted(want)
    if not lora_only:
        assert ("layers", "ssm", "A_log") in want
        assert ("lm_head",) in want
    for path, w in want.items():
        g = got[path]
        assert np.isfinite(g).all(), path
        norm = np.linalg.norm(w.astype(np.float64))
        assert norm > 0, path
        err = np.linalg.norm((g - w).astype(np.float64)) / norm
        limit = A_LOG_REL if path[-1] == "A_log" else GRAD_REL
        assert err <= limit, ("/".join(path), err, limit)


def test_remat_gives_the_same_bits(cfgs, tree):
    """Per-layer recomputation runs the same operations again: the loss
    and every gradient bit for bit."""
    _, tcfg = cfgs
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    tb = {k: _t(v) for k, v in _batch(tcfg).items()}
    runs = [t_sim.pretrain_loss_and_grads(params.tree(), tb, tcfg,
                                          remat=remat)
            for remat in (False, True)]
    assert float(runs[0][0]) == float(runs[1][0])
    off, on = _flat_np(runs[0][1]), _flat_np(runs[1][1])
    for path in off:
        assert np.array_equal(on[path], off[path]), path


def test_forward_needs_whole_ssd_chunks(cfgs, tree):
    """The mixer's chunk is min(128, S) and must divide S: 160 tokens raise
    ``ValueError`` in the port (the reference asserts)."""
    _, tcfg = cfgs
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    toks = _t(_tokens(tcfg, 1, DECODE_SEQ)["tokens"])
    with pytest.raises(ValueError, match="160 % chunk 128"):
        t_model.forward(params, {"tokens": toks}, tcfg, remat=False)


# ---------------------------------------------------------------------------
# decode: the ring past its window, beside the SSD state
# ---------------------------------------------------------------------------

def test_decode_wraps_the_ring_and_matches_reference_and_forward(cfgs, tree):
    """160 teacher-forced ``decode_step`` calls from ``init_cache``
    (float32; 64 ring slots, so the ring wraps twice) against the
    reference's decode (the logits every step, then the whole nested
    cache) and against the port's own ``forward`` (over 256 tokens, whose
    first 160 are these; the forward is causal). A control, the forward
    with the window dropped, misses the same limit past position 64."""
    jcfg, tcfg = cfgs
    toks = _tokens(tcfg, 2, SEQ, seed=11)["tokens"]
    jtree = jax.tree.map(jnp.asarray, tree)
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    with torch.no_grad():
        full, _ = t_model.forward(params, {"tokens": _t(toks)}, tcfg,
                                  remat=False)
        nowin, _ = t_model.forward(params, {"tokens": _t(toks)},
                                   tcfg.with_(sliding_window=None),
                                   remat=False)
    scale = float(full.abs().max())
    jcache = j_model.init_cache(jcfg, 2, DECODE_SEQ, jnp.float32)
    tcache = t_model.init_cache(tcfg, 2, DECODE_SEQ, torch.float32,
                                device="cpu")
    step = jax.jit(j_model.decode_step, static_argnames=("cfg",))
    err_ref, err_fwd, err_ctl = [], [], []
    for t in range(DECODE_SEQ):
        jl, jcache = step(jtree, jcache, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t), cfg=jcfg)
        tl, tcache = t_model.decode_step(params, tcache, _t(toks[:, t:t + 1]),
                                         t, tcfg)
        err_ref.append(float(np.abs(tl.numpy() - np.asarray(jl)).max()))
        err_fwd.append(float((tl - full[:, t]).abs().max()))
        err_ctl.append(float((tl - nowin[:, t]).abs().max()))
    assert max(err_ref) <= DECODE_REL * scale, max(err_ref) / scale
    assert max(err_fwd) <= DECODE_REL * scale, max(err_fwd) / scale
    w = tcfg.sliding_window
    # up to the window the control is the same model; past it, not
    assert max(err_ctl[:w]) <= DECODE_REL * scale
    assert max(err_ctl[w:]) > DECODE_REL * scale, max(err_ctl) / scale
    for part in ("kv", "ssm"):
        for k in tcache[part]:
            _close(tcache[part][k].numpy(), jcache[part][k], CLOSE,
                   f"{part}/{k}")
    np.testing.assert_array_equal(
        tcache["kv"]["pos"][0, 0].numpy(),
        np.arange(DECODE_SEQ - w, DECODE_SEQ)[
            (np.arange(w) - DECODE_SEQ) % w])


# ---------------------------------------------------------------------------
# the client trainers and the merge
# ---------------------------------------------------------------------------

def _trainable(tree):
    jfactors, _ = j_client.split_adapters(tree["lora"])
    return {"factors": jfactors, "head": {}}


def _hold_trained(got, want, before):
    """Every trained leaf normwise within ``TRAINED_REL`` of the change the
    reference's steps made to it."""
    got, before = _flat_np(got), _flat_np(before)
    for path, w in _flat_np(want).items():
        g, b = got[path], before[path]
        change = np.linalg.norm((w - b).astype(np.float64))
        assert change > 0, path
        assert np.linalg.norm((g - w).astype(np.float64)) \
            <= TRAINED_REL * change, path


def _lm_data(cfg, clients, steps, rows, seed):
    data = make_bigram_lm(clients * steps * rows, TRAIN_SEQ, cfg.vocab_size,
                          seed=seed)
    return {k: v.reshape(clients, steps, rows, TRAIN_SEQ)
            for k, v in data.items()}


def test_local_train_matches_reference(cfgs):
    """One step of ``make_local_train`` (4 x 128 next-token rows, all six
    targets at ``RANKS``) from the reference's weights against the
    reference's trainer: the loss and the trained factors; masked rank
    directions stay bit-unchanged."""
    jcfg, tcfg = cfgs
    tree = _tree(seed=1, ranks=RANKS)
    masks = {t: ad["mask"] for t, ad in tree["lora"].items()}
    trainable = _trainable(tree)
    data = {k: v[0] for k, v in _lm_data(tcfg, 1, 1, 4, seed=2).items()}
    jfrozen, _ = j_client.split_head(jax.tree.map(jnp.asarray, tree))
    jtr, jloss = j_client.make_local_train(jcfg, j_opt.adamw(LR))(
        jfrozen, jax.tree.map(jnp.asarray, trainable),
        jax.tree.map(jnp.asarray, masks), jax.tree.map(jnp.asarray, data))
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    tfrozen, head = split_head(params)
    assert head == {} and tfrozen.lm_head is not None
    assert sorted(split_adapters(params.lora)[0]) == sorted(RANKS)
    ttr, tloss = make_local_train(tcfg, t_opt.adamw(LR), device="cpu")(
        tfrozen, interop.tree_from_numpy(trainable, "cpu"),
        interop.tree_from_numpy(masks, "cpu"), data)
    np.testing.assert_allclose(float(tloss), float(jloss), **FWD)
    got = interop.tree_to_numpy(ttr)
    _hold_trained(got, jax.tree.map(np.asarray, jtr), trainable)
    for t, r in RANKS.items():
        np.testing.assert_array_equal(got["factors"][t]["A"][..., r:],
                                      trainable["factors"][t]["A"][..., r:])
        np.testing.assert_array_equal(got["factors"][t]["B"][..., r:, :],
                                      trainable["factors"][t]["B"][..., r:,
                                                                   :])


COHORT_RANKS = (2, 4, 6, 8)


@pytest.fixture(scope="module")
def cohort(cfgs):
    """One step each of a 4-client cohort at ranks 2, 4, 6 and 8 (all six
    targets) through the port's ``make_cohort_train`` and the reference's
    vmapped trainer, from the same weights and data."""
    jcfg, tcfg = cfgs
    tree = _tree(seed=2)
    trainable = jax.tree.map(lambda a: np.stack([a] * len(COHORT_RANKS)),
                             _trainable(tree))
    per = [_masks(jcfg, {t: r for t in jcfg.lora.targets}, seed=7 + i)
           for i, r in enumerate(COHORT_RANKS)]
    masks = {t: np.stack([m[t] for m in per]) for t in jcfg.lora.targets}
    data = _lm_data(tcfg, len(COHORT_RANKS), 1, 2, seed=3)
    jfrozen, _ = j_client.split_head(jax.tree.map(jnp.asarray, tree))
    jtr, jloss = j_client.make_cohort_train(jcfg, j_opt.adamw(LR))(
        jfrozen, jax.tree.map(jnp.asarray, trainable),
        jax.tree.map(jnp.asarray, masks), jax.tree.map(jnp.asarray, data))
    tfrozen, _ = split_head(interop.params_from_jax(tree, tcfg,
                                                    device="cpu"))
    ttr, tloss = make_cohort_train(tcfg, t_opt.adamw(LR), device="cpu")(
        tfrozen, interop.tree_from_numpy(trainable, "cpu"),
        interop.tree_from_numpy(masks, "cpu"), data)
    return dict(trainable=trainable, masks=masks, jtr=jtr, jloss=jloss,
                ttr=ttr, tloss=tloss)


def test_cohort_train_matches_reference_vmap(cohort):
    """The per-client losses and every client's trained factors of the
    4-client cohort against the reference's vmapped trainer."""
    assert cohort["tloss"].shape == (len(COHORT_RANKS),)
    np.testing.assert_allclose(cohort["tloss"].numpy(),
                               np.asarray(cohort["jloss"]), **FWD)
    _hold_trained(interop.tree_to_numpy(cohort["ttr"]),
                  jax.tree.map(np.asarray, cohort["jtr"]),
                  cohort["trainable"])


def test_factored_merge_of_the_cohort_matches_reference_engine(cohort):
    """The 4 clients' trained updates (all six targets: four shape groups,
    q/o, k/v, ssm_in and ssm_out) merged by the port's
    ``AggregationEngine`` (the default factored method) against the
    reference's engine on the same factors: every redistributed client's
    effective update and the spectra."""
    factors = interop.tree_to_numpy(cohort["ttr"])["factors"]
    stack = {t: {"A": f["A"], "B": f["B"], "mask": cohort["masks"][t]}
             for t, f in factors.items()}
    eta = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    got, spec = t_engine.AggregationEngine()(
        interop.tree_from_numpy(stack, "cpu"), _t(eta), ALPHA)
    want, jspec = j_engine.AggregationEngine(use_pallas=False)(
        jax.tree.map(jnp.asarray, stack), jnp.asarray(eta), ALPHA)
    assert sorted(got) == sorted(RANKS)
    shapes = {tuple(ad["A"].shape[2:]) + (ad["B"].shape[-1],)
              for ad in stack.values()}
    assert len(shapes) == 4
    _assert_hlora_close(got, want, MERGE_REL, spec, jspec)


# ---------------------------------------------------------------------------
# the LM example, interop, serving
# ---------------------------------------------------------------------------

def test_lm_example_matches_the_reference_example(monkeypatch, tmp_path):
    """``--arch hymba-1.5b``: 5 steps of the reference example's own loop
    at hymba-reduced (16 x 64 tokens: one SSD chunk, the whole window)
    against the port's ``train`` from the same weights and data (each
    loss, every trained leaf; ``tests/test_torch_lm.py``'s limits)."""
    _hold_train_against_reference_example(
        monkeypatch, tmp_path, _example("lm_pretrain_torch",
                                        "lm_pretrain_torch.py"), ARCH)


def test_lm_example_main_runs_hymba_on_the_cpu():
    """``main(["--arch", "hymba-1.5b", "--device", "cpu", ...])`` takes the
    reduced config and gives ``train``'s losses from the port's own
    seed-0 weights."""
    example = _example("lm_pretrain_torch", "lm_pretrain_torch.py")
    losses = example.main(["--arch", ARCH, "--steps", "3", "--batch", "4",
                           "--seq", "16", "--device", "cpu"])
    tcfg = get_reduced(ARCH)
    _, again = example.train(
        tcfg, t_model.init_params(tcfg, seed=0, device="cpu"),
        make_bigram_lm(4096, 16, tcfg.vocab_size, seed=0), steps=3, batch=4,
        lr=3e-3, remat=True, q_chunk=64, device="cpu")
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)
    assert again == losses


def test_interop_carries_the_hymba_tree_and_keeps_ssm_scalars_float32(
        cfgs, tree):
    """The reference's tree comes across one to one (groups ``ln1``,
    ``attn``, ``ln2``, ``mlp``, ``ssm`` and ``lm_head``) and goes back
    unchanged; under ``dtype=torch.bfloat16`` ``A_log``, ``D`` and
    ``dt_bias`` stay float32 and bit-equal, every other weight is bf16."""
    _, tcfg = cfgs
    f32 = interop.params_from_jax(tree, tcfg, device="cpu")
    assert f32.groups == ("ln1", "attn", "ln2", "mlp", "ssm")
    assert sorted(tree["layers"]) == sorted(f32.groups)
    back = _flat_np(interop.tree_to_numpy(f32.tree()))
    for path, w in _flat_np(tree).items():
        np.testing.assert_array_equal(back[path], w)
    bf = interop.params_from_jax(tree, tcfg, device="cpu",
                                 dtype=torch.bfloat16)
    for group in bf.groups:
        for name, t in bf.layers[group].as_dict().items():
            if group == "ssm" and name in t_ssm.FLOAT32_LEAVES:
                assert t.dtype == torch.float32, name
                np.testing.assert_array_equal(t.numpy(),
                                              tree["layers"]["ssm"][name])
            else:
                assert t.dtype == torch.bfloat16, (group, name)
    assert bf.lm_head.dtype == bf.embed.dtype == torch.bfloat16


def test_serve_engine_refuses_hybrid(cfgs):
    """The engine serves the dense family only, as the reference's does
    (both raise ``NotImplementedError`` on the Hymba config): Hymba
    generation is ``model.decode_step``."""
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro.serve.registry import AdapterRegistry as JAdapterRegistry
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.registry import AdapterRegistry

    jcfg, tcfg = cfgs
    params = t_model.init_params(tcfg, device="cpu")
    registry = AdapterRegistry(tcfg, capacity=1, device="cpu")
    with pytest.raises(NotImplementedError, match="dense transformer"):
        ServeEngine(params, tcfg, registry, device="cpu")
    with pytest.raises(NotImplementedError, match="dense transformer"):
        JServeEngine(j_model.init_params(jax.random.PRNGKey(0), jcfg), jcfg,
                     JAdapterRegistry(jcfg, capacity=1))
