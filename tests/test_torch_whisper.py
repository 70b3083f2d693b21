"""The port's Whisper encoder-decoder against the reference's, on the CPU.

``repro_torch.models.whisper`` (``encode``: the bidirectional encoder over
frame embeddings; ``dec_layer``: causal self-attention, cross-attention
over the encoder's output, the MLP; ``forward``; ``prefill_cache`` and
``decode_step`` with the stacked cross K/V) and the ``audio`` branches of
``repro_torch.models.model`` against ``repro.models.whisper`` and
``repro.models.model``, at ``whisper-reduced`` (2 encoder and 2 decoder
layers, d_model 128, 4 heads of 32, d_ff 256, 32 frames a clip, vocab
256). Inputs come from numpy seeds (the frames stand in for the conv
front end's output); models start from the reference's own seed-0
weights carried over by ``repro_torch.interop``, with live adapters (small
random B) at heterogeneous ranks on q and v, the config's targets, and a
variant on q, k, v and o.

Tolerances, float32 throughout unless named (values O(1)):
- the encoder, a decoder layer, the logits and the loss: rtol 1e-5, atol
  1e-5 of the largest magnitude (``CLOSE``): the same float32 products
  summed in another order;
- every gradient against ``jax.vjp`` of the reference's ``loss_fn``,
  normwise ``GRAD_REL`` (1e-5) of the reference's, except the three key
  biases (the encoder's, the decoder's and cross-attention's ``bk``): a
  key bias adds q.bk to every score of a query's row, which the softmax
  cancels, so its gradient is zero in exact arithmetic and rounding noise
  on either side; each side's is held to ``NOISE_REL`` (1e-5) of the
  largest entry of the same group's ``bq`` gradient, as
  ``tests/test_torch_pretrain.py`` holds RoBERTa's;
- decode in float32 against the reference's decode and the port's
  forward: ``DECODE_REL`` (1e-5) of the logits' largest magnitude, far
  inside the reference test's 2e-3 (``tests/test_models.py``);
- decode with the default bfloat16 cache, float32 weights, against the
  float32 reference: ``chip_smoke.bf16_cache_logit_rel(L)`` of each row's
  rms (the derivation is beside it); the reference refuses that mix
  itself, so its own bfloat16 decode is run with bfloat16 weights too and
  held to the port's at ``BF16_MODEL_REL`` (derived below);
- the trainers: ``tests/test_torch_train.py``'s forward (rtol 1e-4, atol
  1e-5) and trained-factor (normwise 1e-3 of the change the steps made)
  tolerances; the merge: ``tests/test_torch_aggregate.py``'s (every
  client's effective update normwise 1e-4, spectra rtol 1e-4);
- ``remat`` within the port: the same bits.
"""
import copy
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.configs.base import LoRAConfig as JLoRAConfig
from repro.core import agg_engine as j_engine
from repro.fed import client as j_client
from repro.models import model as j_model
from repro.models import transformer as j_tf
from repro.models import whisper as j_whisper
from repro.optim import optimizers as j_opt
from repro_torch import checkpoint as t_store
from repro_torch import interop
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import LoRAConfig
from repro_torch.core import agg_engine as t_engine
from repro_torch.core import lora as t_lora
from repro_torch.data import make_bigram_lm
from repro_torch.fed import (make_cohort_train, make_local_train,
                             simulation as t_sim, split_adapters, split_head)
from repro_torch.models import common as t_common
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_tf
from repro_torch.models import whisper as t_whisper
from repro_torch.optim import optimizers as t_opt
from repro_torch.optim.optimizers import tree_leaves
from test_torch_aggregate import ALPHA, _assert_hlora_close
from test_torch_lm import (_example, _flat_np,
                           _hold_train_against_reference_example, _paths,
                           _t)
from test_torch_registry import _chip_smoke

ARCH = "whisper-small"
CLOSE = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-5
NOISE_REL = 1e-5
DECODE_REL = 1e-5
FWD = dict(rtol=1e-4, atol=1e-5)
LR = 1e-3
TRAINED_REL = 1e-3
MERGE_REL = 1e-4
SEQ = 24              # decoder tokens: three query chunks of 8 below
Q_CHUNK = 8
RANKS = {"q": 3, "v": 6}
QKVO_RANKS = {"q": 3, "k": 5, "v": 6, "o": 2}
NOISE_LEAVES = (("encoder", "attn", "bk"), ("layers", "attn", "bk"),
                ("layers", "xattn", "bk"))
BF16_CACHE_REL = _chip_smoke().bf16_cache_logit_rel


def BF16_MODEL_REL(dec_layers: int, enc_layers: int) -> float:
    """Two bfloat16 evaluations of the model (weights and cache), each
    rounding at its own points: ``chip_smoke.bf16_logit_rel``'s derivation
    with Whisper's count. A decoder layer rounds 31 values (the three
    norms; q and v's base product, LoRA delta, sum and bias; k's product
    and bias; the self- and cross-attention probabilities and outputs;
    cross-attention's q, o and self-attention's o, each product and bias;
    the MLP's two products, two biases and GELU; three residual adds) and
    reads 10 rounded from float32 (8 weight matrices, the cached cross K
    and V): 41. An encoder layer rounds 19 and reads 6: 25, reaching the
    logits through cross-attention's K and V at their own relative size
    to first order. Plus 6 outside the layers (frames plus positions, the
    encoder's norm, the embedding and its scale, the final norm, the
    head)."""
    n = 41 * dec_layers + 25 * enc_layers + 6
    return _chip_smoke().BF16_SIGMAS * math.sqrt(2 * n) * 2.0 ** -8 \
        / math.sqrt(3)


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
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want,
                               rtol=tol["rtol"],
                               atol=tol["atol"] * max(np.abs(want).max(),
                                                      1e-30),
                               err_msg=what)


def _cfgs(targets=None):
    """(reference config, port config) at whisper-reduced, the adapters on
    ``targets`` (None: the config's q and v)."""
    jcfg, tcfg = j_get_reduced(ARCH), get_reduced(ARCH)
    if targets is not None:
        jcfg = jcfg.with_(lora=JLoRAConfig(targets=targets))
        tcfg = tcfg.with_(lora=LoRAConfig(targets=targets))
    return jcfg, tcfg


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


def _tree(jcfg, seed=0, ranks=None):
    """The reference's seed-``seed`` weights as numpy, with live adapters
    (B small and random) at ``ranks`` ({target: rank}; None: r_max)."""
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
    return _cfgs()


@pytest.fixture(scope="module")
def tree(cfgs):
    return _tree(cfgs[0], ranks=RANKS)


def _frames(cfg, rows=2, seed=4):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (rows, cfg.encoder_seq, cfg.d_model))).astype(np.float32)


def _batch(cfg, rows=2, seq=SEQ, seed=9):
    data = make_bigram_lm(rows, seq, cfg.vocab_size, seed=seed)
    labels = data["labels"].copy()
    labels[:, -2:] = -1                 # a few positions not scored
    return {"tokens": data["tokens"], "labels": labels,
            "frames": _frames(cfg, rows, seed + 1)}


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


_J_PREFILL = jax.jit(j_whisper.prefill_cache,
                     static_argnames=("cfg", "batch", "max_seq", "dtype"))


@jax.jit
def _j_encode(jt, frames):
    return j_whisper.encode(jt, frames, j_get_reduced(ARCH))


@partial(jax.jit, static_argnames=("remat", "q_chunk"))
def _j_forward_and_loss(jt, jb, remat, q_chunk):
    jcfg = j_get_reduced(ARCH)
    logits, aux = j_model.forward(jt, jb, jcfg, remat=remat,
                                  q_chunk=q_chunk)
    total, metrics = j_model.loss_fn(jt, jb, jcfg, remat=remat,
                                     q_chunk=q_chunk)
    return logits, aux, total, metrics


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_match_reference():
    """``CONFIG``, ``reduced()``, their derived widths, ``param_count`` (the
    reference's count: the encoder's layers and the decoder's
    cross-attention, and an untied vocab x d head that Whisper does not
    have, since ``tie_embeddings`` is left False) and the LoRA targets'
    shapes, field for field against the reference's; the alias."""
    fields = ("name", "arch_type", "num_layers", "encoder_layers",
              "encoder_seq", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "resolved_head_dim", "d_ff", "vocab_size",
              "rope_theta", "activation", "tie_embeddings", "use_bias",
              "sliding_window", "source")
    for jc, tc in ((j_get_config(ARCH), get_config(ARCH)),
                   (j_get_reduced(ARCH), get_reduced(ARCH))):
        for f in fields:
            assert getattr(jc, f) == getattr(tc, f), f
        assert jc.lora.targets == tc.lora.targets == ("q", "v")
        assert (jc.lora.r_max, jc.lora.alpha) == (tc.lora.r_max,
                                                  tc.lora.alpha)
        assert jc.param_count() == tc.param_count()
        assert jc.active_param_count() == tc.active_param_count()
        assert j_tf.lora_specs(jc) == t_tf.lora_specs(tc)
    assert get_config(ARCH).param_count() == 277_845_504
    assert get_reduced(ARCH).param_count() == 720_896
    assert get_config("whisper_small") == get_config(ARCH)
    assert t_tf.lora_specs(get_config(ARCH)) == {"q": (768, 768),
                                                 "v": (768, 768)}


# ---------------------------------------------------------------------------
# init and the caches
# ---------------------------------------------------------------------------

def _keys(tree):
    """The nested key layout of a tree, leaves dropped."""
    return {k: _keys(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else None


def test_init_params_and_caches_shapes_and_dtypes(cfgs):
    """The port's own init has the reference's layout key for key
    (``embed``, ``encoder``, ``enc_norm``, ``layers`` with ``lnx`` and
    ``xattn``, ``final_norm``, ``lora``; no ``lm_head``: the head is the
    embedding), its shapes and dtypes and its scales (layer norms at ones
    and zeros); ``init_cache`` the reference's shapes and dtypes in
    bfloat16 (the default) and float32 (``prefill_cache``'s are held with
    its values by the decode tests)."""
    jcfg, tcfg = cfgs
    jtree = jax.tree.map(np.asarray, j_model.init_params(
        jax.random.PRNGKey(0), jcfg))
    p = t_model.init_params(tcfg, seed=0, device="cpu")
    assert _keys(p.tree()) == _keys(jtree)
    got, want = _flat_np(p.tree()), _flat_np(jtree)
    for path, w in want.items():
        assert got[path].shape == w.shape and got[path].dtype == w.dtype, path
    assert p.lm_head is None and p.head().data_ptr() == p.embed.data_ptr()
    assert p.groups == ("ln1", "attn", "ln2", "mlp", "lnx", "xattn")
    for part in (p.tree()["encoder"], p.tree()["layers"]):
        for g in ("ln1", "ln2"):
            assert bool((part[g]["w"] == 1).all()) and not part[g]["b"].any()
    wq = p.encoder["attn"].wq
    assert abs(float(wq.std()) * tcfg.d_model ** 0.5 - 1.0) < 0.05
    # cross-attention's weights are their own draws
    assert not torch.equal(p.layers["xattn"].wq, p.layers["attn"].wq)
    for dtype, jdtype in ((None, None), (torch.float32, jnp.float32)):
        kw = {} if dtype is None else {"dtype": dtype}
        jkw = {} if jdtype is None else {"dtype": jdtype}
        tc = t_model.init_cache(tcfg, 3, SEQ, device="cpu", **kw)
        jc = j_model.init_cache(jcfg, 3, SEQ, **jkw)
        assert _keys(tc) == _keys(jc)
        got = _paths(tc)
        for path, w in _paths(jc).items():
            assert tuple(got[path].shape) == w.shape, path
            assert str(got[path].dtype).split(".")[1] == str(w.dtype), path
        assert bool((tc["self"]["pos"] == -1).all())
    assert tc["cross_k"].shape == (tcfg.num_layers, 3, tcfg.encoder_seq,
                                   tcfg.num_kv_heads, tcfg.resolved_head_dim)
    assert t_model.init_cache(tcfg, 1, 4, device="cpu")[
        "self"]["k"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the encoder, a decoder layer, the forward, the loss and its gradients
# ---------------------------------------------------------------------------

def test_encode_and_dec_layer_match_reference(cfgs, tree):
    """``encode`` over 2 clips of 32 frames, then ``dec_layer`` of layer 0
    on 2 x 24 tokens with its cross K/V (``cross_kv`` of the encoder's
    output) and live adapters on q and v, in query chunks of 8, against
    the reference's; ``apply_q`` too. The adapters act (dropping them
    moves the layer)."""
    jcfg, tcfg = cfgs
    frames = _frames(tcfg)
    jt = jax.tree.map(jnp.asarray, tree)
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    enc_j = _j_encode(jt, jnp.asarray(frames))
    with torch.no_grad():
        enc_t = t_whisper.encode(params, _t(frames), tcfg)
    _close(enc_t.numpy(), enc_j, CLOSE, "encode")
    x = (0.5 * np.random.default_rng(6).standard_normal(
        (2, SEQ, tcfg.d_model))).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], tree["layers"])
    ad = jax.tree.map(lambda a: a[0], tree["lora"])
    jlp = jax.tree.map(jnp.asarray, lp)
    kv = j_whisper.cross_kv(enc_j, jlp["xattn"], jcfg)
    yj = jax.jit(partial(j_whisper.dec_layer, cfg=jcfg,
                         positions=jnp.arange(SEQ)[None, :],
                         q_chunk=Q_CHUNK))(
        jnp.asarray(x), jlp, jax.tree.map(jnp.asarray, ad), kv)
    qj = j_whisper.apply_q(jnp.asarray(x), jlp["xattn"], jcfg)
    tlp = interop.tree_from_numpy(lp, "cpu")
    tad = interop.tree_from_numpy(ad, "cpu")
    with torch.no_grad():
        tkv = t_whisper.cross_kv(enc_t, tlp["xattn"], tcfg)
        yt = t_whisper.dec_layer(_t(x), tlp, tad, tkv, tcfg,
                                 q_chunk=Q_CHUNK)
        bare = t_whisper.dec_layer(_t(x), tlp, {}, tkv, tcfg,
                                   q_chunk=Q_CHUNK)
        qt = t_whisper.apply_q(_t(x), tlp["xattn"], tcfg)
    for got, want, what in ((tkv[0], kv[0], "cross k"),
                            (tkv[1], kv[1], "cross v"), (qt, qj, "apply_q"),
                            (yt, yj, "dec_layer")):
        _close(got.numpy(), want, CLOSE, what)
    assert float((bare - yt).abs().max()) > 1e-4


@pytest.mark.parametrize("remat, q_chunk", [(False, Q_CHUNK), (True, 1024)])
def test_forward_and_loss_match_reference(cfgs, tree, remat, q_chunk):
    """The logits over 2 x 24 tokens on 2 clips (decoder queries in chunks
    of 8, or in one) and the LM loss with its metrics (aux a float32 zero)
    against the reference's ``forward`` and ``loss_fn``, with ``remat``
    off and on."""
    jcfg, tcfg = cfgs
    batch = _batch(tcfg)
    jl, jaux, total_j, m_j = _j_forward_and_loss(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch),
        remat, q_chunk)
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    tb = _tb(batch)
    with torch.no_grad():
        logits, aux = t_model.forward(params, tb, tcfg, remat=remat,
                                      q_chunk=q_chunk)
        total_t, m_t = t_model.loss_fn(params, tb, tcfg, remat=remat,
                                       q_chunk=q_chunk)
    _close(logits.numpy(), jl, CLOSE, "logits")
    assert aux.dtype == torch.float32 and float(aux) == float(jaux) == 0
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


def _hold_grads(got, want):
    """Every gradient normwise within ``GRAD_REL`` of the reference's; the
    key biases held to rounding noise on both sides."""
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert np.isfinite(g).all(), path
        if path in NOISE_LEAVES:
            ref = path[:-1] + ("bq",)
            for side in (got, want):
                assert np.abs(side[path]).max() <= NOISE_REL * np.abs(
                    side[ref]).max(), path
            continue
        norm = np.linalg.norm(w.astype(np.float64))
        assert norm > 0, path
        err = np.linalg.norm((g - w).astype(np.float64)) / norm
        assert err <= GRAD_REL, ("/".join(path), err)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("mode", ["backbone", "lora"])
def test_every_gradient_matches_jax_vjp(cfgs, tree, mode, remat):
    """Backbone mode (``pretrain_loss_and_grads``: every leaf, the
    embedding, the encoder, enc_norm, self- and cross-attention, the norms,
    the MLPs and the adapters) and LoRA mode (q's and v's A, B and masks
    over the frozen model) against ``jax.vjp`` of the reference's loss,
    normwise; the key biases held to noise size."""
    jcfg, tcfg = cfgs
    batch = _batch(tcfg)
    lora_only = mode == "lora"
    loss_j, grads_j = _vjp_grads(jcfg, tree, batch, remat, lora_only)
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    tb = _tb(batch)
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
        assert ("encoder", "mlp", "w1") in got and ("enc_norm", "b") in got
    np.testing.assert_allclose(float(loss_t.detach()), loss_j, rtol=1e-5)
    _hold_grads(got, _flat_np(grads_j))


def test_qkvo_variant_cross_attention_carries_no_adapter():
    """With adapters on q, k, v and o: the loss and every adapter's
    gradient match the reference's (which adapts self-attention only);
    every ``apply_lora`` call that reaches one of cross-attention's (or
    the encoder's) weights carries no adapter, and each of the decoder's
    self-attention weights gets its own."""
    jcfg, tcfg = _cfgs(("q", "k", "v", "o"))
    tree = _tree(jcfg, seed=1, ranks=QKVO_RANKS)
    batch = _batch(tcfg, seed=12)
    loss_j, grads_j = _vjp_grads(jcfg, tree, batch, False, True)
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    calls = []
    apply_lora = t_lora.apply_lora

    def recording(x, w0, adapter, alpha):
        calls.append((w0.data_ptr(), adapter is not None))
        return apply_lora(x, w0, adapter, alpha)

    xattn = {params.layers["xattn"].as_dict(layer)[n].data_ptr()
             for layer in range(tcfg.num_layers)
             for n in ("wq", "wk", "wv", "wo")}
    encoder = {t.data_ptr() for t in tree_leaves(params.encoder_groups())}
    selfattn = {params.layers["attn"].as_dict(layer)[n].data_ptr()
                for layer in range(tcfg.num_layers)
                for n in ("wq", "wk", "wv", "wo")}
    p = copy.copy(params)
    p.lora = {t: {k: v.clone().requires_grad_(True) for k, v in
                  ad.items()} for t, ad in params.lora.items()}
    t_common.apply_lora = recording
    try:
        loss_t, _ = t_model.loss_fn(p, _tb(batch), tcfg, remat=False)
    finally:
        t_common.apply_lora = apply_lora
    paths = [(t, k) for t in sorted(p.lora) for k in sorted(p.lora[t])]
    gs = torch.autograd.grad(loss_t, [p.lora[t][k] for t, k in paths])
    np.testing.assert_allclose(float(loss_t.detach()), loss_j, rtol=1e-5)
    _hold_grads({path: g.numpy() for path, g in zip(paths, gs)},
                _flat_np(grads_j))
    adapted = {ptr for ptr, live in calls if live}
    assert adapted == selfattn
    assert not adapted & (xattn | encoder)
    assert {ptr for ptr, _ in calls} >= {
        params.layers["xattn"].as_dict(layer)["wo"].data_ptr()
        for layer in range(tcfg.num_layers)}


def test_remat_gives_the_same_bits(cfgs, tree):
    """Per-layer recomputation runs the same operations again (the cross
    K/V included): the loss and every gradient bit for bit."""
    _, tcfg = cfgs
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    tb = _tb(_batch(tcfg))
    runs = [t_sim.pretrain_loss_and_grads(params.tree(), tb, tcfg,
                                          remat=remat)
            for remat in (False, True)]
    assert float(runs[0][0]) == float(runs[1][0])
    off, on = _flat_np(runs[0][1]), _flat_np(runs[1][1])
    for path in off:
        assert np.array_equal(on[path], off[path]), path


def test_forward_without_frames_raises(cfgs, tree):
    """``forward`` and ``loss_fn`` need ``batch["frames"]``: ``ValueError``
    in the port (the reference asserts)."""
    jcfg, tcfg = cfgs
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    batch = _tb(_batch(tcfg))
    del batch["frames"]
    with pytest.raises(ValueError, match="frame embeddings"):
        t_model.forward(params, batch, tcfg, remat=False)
    with pytest.raises(ValueError, match="frame embeddings"):
        t_model.loss_fn(params, batch, tcfg, remat=False)
    with pytest.raises(AssertionError, match="frame embeddings"):
        j_model.forward(jax.tree.map(jnp.asarray, tree),
                        {"tokens": jnp.asarray(batch["tokens"].numpy())},
                        jcfg)


# ---------------------------------------------------------------------------
# decode: the prefilled cross K/V and the self-attention cache
# ---------------------------------------------------------------------------

def _decode(cfgs, tree, dtype, frames, toks):
    """The port's ``prefill_cache`` (``dtype`` None: the default) and a
    teacher-forced ``decode_step`` a token; (logits (S, B, V), cache)."""
    _, tcfg = cfgs
    params = interop.params_from_jax(
        tree, tcfg, device="cpu",
        dtype=torch.bfloat16 if dtype == "bf16 model" else None)
    kw = {"dtype": dtype} if isinstance(dtype, torch.dtype) else {}
    cache = t_whisper.prefill_cache(params, _t(frames).to(params.embed.dtype),
                                    tcfg, toks.shape[0], toks.shape[1], **kw)
    out = []
    for t in range(toks.shape[1]):
        lg, cache = t_model.decode_step(params, cache, _t(toks[:, t:t + 1]),
                                        t, tcfg)
        out.append(lg)
    return torch.stack(out), cache


def _j_decode(jcfg, jtree, frames, toks, dtype):
    cache = _J_PREFILL(jtree, jnp.asarray(frames).astype(
        jtree["embed"].dtype), cfg=jcfg, batch=toks.shape[0],
        max_seq=toks.shape[1], dtype=dtype)
    step = jax.jit(j_model.decode_step, static_argnames=("cfg",))
    out = []
    for t in range(toks.shape[1]):
        lg, cache = step(jtree, cache, jnp.asarray(toks[:, t:t + 1]),
                         jnp.int32(t), cfg=jcfg)
        out.append(np.asarray(lg.astype(jnp.float32)))
    return np.stack(out), cache


def test_prefill_and_decode_match_reference_and_forward(cfgs, tree):
    """Float32: ``prefill_cache`` on 2 clips (the cross K/V against the
    reference's), then 24 teacher-forced ``decode_step`` calls against the
    reference's decode (the logits every step, then the whole cache) and
    against the port's own ``forward``; the cross K/V are only read."""
    jcfg, tcfg = cfgs
    batch = _batch(tcfg, seed=13)
    toks, frames = batch["tokens"], batch["frames"]
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    with torch.no_grad():
        full, _ = t_model.forward(params, _tb(batch), tcfg, remat=False)
    scale = float(full.abs().max())
    jl, jcache = _j_decode(jcfg, jax.tree.map(jnp.asarray, tree), frames,
                           toks, jnp.float32)
    tl, tcache = _decode(cfgs, tree, torch.float32, frames, toks)
    prefilled = t_whisper.prefill_cache(params, _t(frames), tcfg, 2, SEQ,
                                        torch.float32)
    for k in ("cross_k", "cross_v"):
        assert torch.equal(tcache[k], prefilled[k]), k
    assert float(np.abs(tl.numpy() - jl).max()) <= DECODE_REL * scale
    assert float((tl - full.transpose(0, 1)).abs().max()) \
        <= DECODE_REL * scale
    for path, w in _flat_np(jcache).items():
        _close(_flat_np(tcache)[path], w, CLOSE, "/".join(path))


def test_decode_at_the_default_bfloat16_cache(cfgs, tree):
    """The default cache dtype, bfloat16. With float32 weights the
    reference raises (its ``cache_insert`` writes float32 K/V into the
    bfloat16 cache); the port casts each attention output up to its
    projection's dtype (exact) and is held to the reference's float32
    decode within ``BF16_CACHE_REL`` of each row's rms. With bfloat16
    weights too, the reference runs: the two bfloat16 decodes within
    ``BF16_MODEL_REL`` of the row's rms of the reference's float32
    logits."""
    jcfg, tcfg = cfgs
    batch = _batch(tcfg, seed=14)
    toks, frames = batch["tokens"], batch["frames"]
    jtree = jax.tree.map(jnp.asarray, tree)
    want, _ = _j_decode(jcfg, jtree, frames, toks, jnp.float32)
    rms = np.sqrt((want.astype(np.float64) ** 2).mean(-1, keepdims=True))
    with pytest.raises(TypeError, match="same dtypes"):
        _j_decode(jcfg, jtree, frames, toks[:, :1], jnp.bfloat16)
    got, cache = _decode(cfgs, tree, None, frames, toks)
    assert cache["self"]["k"].dtype == cache["cross_k"].dtype \
        == torch.bfloat16 and got.dtype == torch.float32
    err = np.abs(got.numpy() - want) / rms
    assert err.max() <= BF16_CACHE_REL(tcfg.num_layers), err.max()
    assert err.max() > 0
    jbf = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jtree)
    jbf16, jcache = _j_decode(jcfg, jbf, frames, toks, jnp.bfloat16)
    tbf16, tcache = _decode(cfgs, tree, "bf16 model", frames, toks)
    for path, w in _paths(jcache).items():
        got = _paths(tcache)[path]
        assert tuple(got.shape) == w.shape, path
        assert str(got.dtype).split(".")[1] == str(w.dtype), path
    err = np.abs(tbf16.float().numpy() - jbf16) / rms
    assert err.max() <= BF16_MODEL_REL(tcfg.num_layers,
                                       tcfg.encoder_layers), err.max()


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
    """Next-token rows with a ``frames`` leaf (clients, steps, rows,
    S_enc, d)."""
    data = make_bigram_lm(clients * steps * rows, SEQ, cfg.vocab_size,
                          seed=seed)
    out = {k: v.reshape(clients, steps, rows, SEQ) for k, v in data.items()}
    out["frames"] = _frames(cfg, clients * steps * rows, seed + 1).reshape(
        clients, steps, rows, cfg.encoder_seq, cfg.d_model)
    return out


def test_local_train_matches_reference(cfgs):
    """Two steps of ``make_local_train`` (4 clips and 4 x 24 next-token
    rows a step, q and v at ``RANKS``) from the reference's weights
    against the reference's trainer: the loss and the trained factors;
    masked rank directions stay bit-unchanged."""
    jcfg, tcfg = cfgs
    tree = _tree(jcfg, seed=1, ranks=RANKS)
    masks = {t: ad["mask"] for t, ad in tree["lora"].items()}
    trainable = _trainable(tree)
    data = {k: v[0] for k, v in _lm_data(tcfg, 1, 2, 4, seed=2).items()}
    jfrozen, _ = j_client.split_head(jax.tree.map(jnp.asarray, tree))
    jtr, jloss = j_client.make_local_train(jcfg, j_opt.adamw(LR))(
        jfrozen, jax.tree.map(jnp.asarray, trainable),
        jax.tree.map(jnp.asarray, masks), jax.tree.map(jnp.asarray, data))
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    tfrozen, head = split_head(params)
    assert head == {} and tfrozen.encoder is params.encoder
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
    """One step each of a 4-client cohort at ranks 2, 4, 6 and 8 (q and v)
    through the port's ``make_cohort_train`` and the reference's vmapped
    trainer, from the same weights and data (each client its own clips)."""
    jcfg, tcfg = cfgs
    tree = _tree(jcfg, seed=2)
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
    """The 4 clients' trained updates (q and v, both d x d: one shape
    group) merged by the port's ``AggregationEngine`` (the default factored
    method) against the reference's engine on the same factors: every
    redistributed client's effective update and the spectra."""
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
    assert len(shapes) == 1
    _assert_hlora_close(got, want, MERGE_REL, spec, jspec)


# ---------------------------------------------------------------------------
# the LM example, interop, the store, serving
# ---------------------------------------------------------------------------

def test_lm_example_matches_the_reference_example(monkeypatch, tmp_path):
    """``--arch whisper-small``: 5 steps of the reference example's own
    loop at whisper-reduced (16 x 64 tokens, zero frames of 32 x 128 a
    row) against the port's ``train`` from the same weights and data (each
    loss, every trained leaf; ``tests/test_torch_lm.py``'s limits, the
    key biases held as that helper holds noise leaves)."""
    _hold_train_against_reference_example(
        monkeypatch, tmp_path, _example("lm_pretrain_torch",
                                        "lm_pretrain_torch.py"), ARCH,
        noise=NOISE_LEAVES)


def test_lm_example_main_runs_whisper_on_the_cpu():
    """``main(["--arch", "whisper-small", "--device", "cpu", ...])`` takes
    the reduced config, gives every batch zero frames and gives
    ``train``'s losses from the port's own seed-0 weights."""
    example = _example("lm_pretrain_torch", "lm_pretrain_torch.py")
    losses = example.main(["--arch", ARCH, "--steps", "3", "--batch", "4",
                           "--seq", "16", "--device", "cpu"])
    tcfg = get_reduced(ARCH)
    seen = []
    grad_step = t_sim.pretrain_loss_and_grads

    def hooked(tree, batch, cfg, **kw):
        seen.append(batch["frames"])
        return grad_step(tree, batch, cfg, **kw)

    t_sim.pretrain_loss_and_grads = hooked
    try:
        _, again = example.train(
            tcfg, t_model.init_params(tcfg, seed=0, device="cpu"),
            make_bigram_lm(4096, 16, tcfg.vocab_size, seed=0), steps=3,
            batch=4, lr=3e-3, remat=True, q_chunk=64, device="cpu")
    finally:
        t_sim.pretrain_loss_and_grads = grad_step
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)
    assert again == losses
    assert [tuple(f.shape) for f in seen] == [(4, 32, 128)] * 3
    assert not any(bool(f.any()) for f in seen)


def test_interop_and_the_store_carry_the_whisper_tree(cfgs, tree, tmp_path):
    """The reference's tree comes across one to one (``encoder`` and
    ``enc_norm`` included) and goes back unchanged; the port's store saves
    the port's tree and restores it bit for bit into a module whose logits
    are ``CLOSE`` to the original's (the loaded arrays' alignment can pick
    other CPU GEMM paths: rounding-level, 5e-7 here); the reference's store
    reads the port's checkpoint and the port's reads the reference's."""
    from repro.checkpoint import store as j_store
    jcfg, tcfg = cfgs
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    assert params.encoder is not None and params.enc_norm is not None
    back = _flat_np(interop.tree_to_numpy(params.tree()))
    want = _flat_np(tree)
    assert sorted(back) == sorted(want)
    for path, w in want.items():
        np.testing.assert_array_equal(back[path], w)
    t_store.save(str(tmp_path / "port"), 3, params.tree(),
                 meta={"arch": tcfg.name})
    restored, meta = t_store.restore(str(tmp_path / "port"), device="cpu")
    assert meta["step"] == 3
    again = t_tf.Transformer.from_tree(tcfg, restored)
    got = _flat_np(again.tree())
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w)
    batch = _tb(_batch(tcfg))
    with torch.no_grad():
        a, _ = t_model.forward(params, batch, tcfg, remat=False)
        b, _ = t_model.forward(again, batch, tcfg, remat=False)
    _close(b.numpy(), a.numpy(), CLOSE, "restored logits")
    jread, _ = j_store.restore(str(tmp_path / "port"))
    for path, w in want.items():
        np.testing.assert_array_equal(np.asarray(_flat_np(jread)[path]), w)
    j_store.save(str(tmp_path / "ref"), 1, jax.tree.map(jnp.asarray, tree))
    pread, _ = t_store.restore(str(tmp_path / "ref"), device="cpu")
    for path, w in _flat_np(pread).items():
        np.testing.assert_array_equal(w, want[path])


def test_serve_engine_refuses_audio(cfgs):
    """The engine serves the dense family only, as the reference's does
    (both raise ``NotImplementedError`` on the Whisper config): Whisper
    generation is ``whisper.prefill_cache`` and ``model.decode_step``."""
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
