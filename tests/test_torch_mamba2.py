"""The port's Mamba2 state-space family against the reference's, on the CPU.

``repro_torch.models.mamba2`` (the chunked SSD scan, its recurrent step,
the causal conv and its one-step form, the mixer and its decode step) and
the ``ssm`` branches of ``repro_torch.models.model`` against
``repro.models.mamba2`` and ``repro.models.model``, at ``mamba2-reduced``
(2 layers, d_model 128, d_inner 256, ssm_state 16, head_dim 32: 8 heads).
Inputs come from numpy seeds; models start from the reference's own
seed-0 weights carried over by ``repro_torch.interop``, with live adapters
(small random B) at heterogeneous ranks where a test says so.

Tolerances, float32 throughout (values O(1)):
- ``ssd_chunked``, ``ssd_step``, ``causal_conv``, ``conv_step`` against the
  reference's: rtol 1e-5, atol 1e-5 of the output's largest magnitude
  (``CLOSE``): the same float32 products summed in another order;
- the port's own chunk invariance, and the recurrent step against the
  chunked scan: rtol 1e-4, atol 1e-4 (``tests/test_models.py``'s, whose
  16-against-64 check this mirrors): the two forms sum the decays in
  different orders (exp of a cumulative sum against a product of exps);
- the mixer, its step and the model's logits: rtol 1e-5, atol 1e-5 of the
  largest logit;
- the scan's gradients (every input, the initial state included) against
  ``jax.vjp`` of the reference's: normwise ``GRAD_REL`` (1e-5), as in
  ``tests/test_torch_lm.py`` (measured at most 4.6e-6, on ``a`` at chunk
  64);
- the loss: rtol 1e-5; every leaf's gradient against ``jax.grad``
  normwise, ||port - ref|| <= ``GRAD_REL`` of ||ref||, except ``A_log``,
  named: its gradient sums decay derivatives that nearly cancel (norm
  ~3e-4 against ~0.5 for the projections), and the two sides part by
  1.4e-5-1.5e-5 of it, so it is held to ``A_LOG_REL`` (1e-4) of the
  reference's gradient. A detached decay moves it by O(1) of itself;
- decode against the reference's decode and against the port's own
  forward: ``DECODE_REL`` (1e-5) of the logits' largest magnitude, far
  inside the reference test's 2e-3 (``tests/test_models.py``);
- the trainers after their steps: ``tests/test_torch_train.py``'s forward
  (rtol 1e-4, atol 1e-5) and trained-factor (normwise 1e-3 of the change
  the steps made) tolerances;
- ``remat`` within the port: the same bits.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.fed import client as j_client
from repro.models import mamba2 as j_ssm
from repro.models import model as j_model
from repro.models import transformer as j_tf
from repro.optim import optimizers as j_opt
from repro_torch import interop
from repro_torch.configs import get_config, get_reduced
from repro_torch.data import make_bigram_lm
from repro_torch.fed import (make_cohort_train, make_local_train,
                             simulation as t_sim, split_adapters, split_head)
from repro_torch.models import mamba2 as t_ssm
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_tf
from repro_torch.optim import optimizers as t_opt
from test_torch_lm import (_example, _flat_np,
                           _hold_train_against_reference_example, _t)

ARCH = "mamba2-2.7b"
CLOSE = dict(rtol=1e-5, atol=1e-5)
LOOSE = dict(rtol=1e-4, atol=1e-4)
GRAD_REL = 1e-5
A_LOG_REL = 1e-4
DECODE_REL = 1e-5
FWD = dict(rtol=1e-4, atol=1e-5)
LR = 1e-3
TRAINED_REL = 1e-3
SEQ = 32


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
    return _tree(ranks={"ssm_in": 3, "ssm_out": 6})


def _ssd_inputs(seed=0, b=2, s=64, h=4, p=8, n=16):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f)
    a = -np.exp(0.2 * rng.standard_normal(h)).astype(f)
    bm = rng.standard_normal((b, s, n)).astype(f)
    cm = rng.standard_normal((b, s, n)).astype(f)
    s0 = rng.standard_normal((b, h, p, n)).astype(f)
    return x, dt, a, bm, cm, s0


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_match_reference():
    """``CONFIG``, ``reduced()``, their derived widths, ``param_count`` and
    the LoRA targets' shapes, field for field against the reference's."""
    fields = ("name", "arch_type", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "d_ff", "vocab_size", "ssm_state",
              "ssm_expand", "ssm_head_dim", "ssm_conv_width", "activation",
              "tie_embeddings", "use_bias", "source", "d_inner", "ssm_heads",
              "is_attention_free")
    for jc, tc in ((j_get_config(ARCH), get_config(ARCH)),
                   (j_get_reduced(ARCH), get_reduced(ARCH))):
        for f in fields:
            assert getattr(jc, f) == getattr(tc, f), f
        assert jc.lora.targets == tc.lora.targets == ("ssm_in", "ssm_out")
        assert (jc.lora.r_max, jc.lora.alpha) == (tc.lora.r_max,
                                                  tc.lora.alpha)
        assert jc.param_count() == tc.param_count()
        assert jc.active_param_count() == tc.active_param_count()
        assert j_tf.lora_specs(jc) == t_tf.lora_specs(tc)
    full = get_config(ARCH)
    assert full.param_count() == 2_700_349_440
    assert (full.d_inner, full.ssm_heads) == (5120, 80)
    assert t_tf.lora_specs(full) == {"ssm_in": (2560, 10576),
                                     "ssm_out": (5120, 2560)}


# ---------------------------------------------------------------------------
# the SSD scan, its step, the conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_ssd_chunked_matches_reference(chunk):
    """y and the final state from an ``init_state``, against the
    reference's at the same chunk (4, 2 and 1 chunks of 64 positions)."""
    x, dt, a, bm, cm, s0 = _ssd_inputs()
    yj, sj = j_ssm.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)),
                               chunk=chunk, init_state=jnp.asarray(s0))
    yt, st = t_ssm.ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm)),
                               chunk=chunk, init_state=_t(s0))
    assert yt.dtype == st.dtype == torch.float32
    _close(yt.numpy(), yj, CLOSE, "y")
    _close(st.numpy(), sj, CLOSE, "state")


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_ssd_chunked_gradients_match_reference(chunk):
    """The gradient of y and of the final state (random cotangents) with
    respect to every input and the initial state, against ``jax.vjp`` of
    the reference's scan: the carry across chunks, its decays in and out,
    and the intra-chunk decay all sit on this path."""
    ins = _ssd_inputs(seed=3)
    rng = np.random.default_rng(4)
    gy, gs = (rng.standard_normal(v.shape).astype(np.float32)
              for v in (ins[0], ins[5]))

    def ref(x, dt, a, bm, cm, s0):
        return j_ssm.ssd_chunked(x, dt, a, bm, cm, chunk=chunk, init_state=s0)

    _, vjp = jax.vjp(ref, *(jnp.asarray(v) for v in ins))
    want = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    tin = [_t(v).requires_grad_() for v in ins]
    y, st = t_ssm.ssd_chunked(*tin[:5], chunk=chunk, init_state=tin[5])
    got = torch.autograd.grad((y, st), tin, (_t(gy), _t(gs)))
    for name, g, w in zip(("x", "dt", "a", "bmat", "cmat", "init_state"),
                          got, want):
        w = np.asarray(w, np.float64)
        assert np.isfinite(g.numpy()).all(), name
        err = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert err <= GRAD_REL, (name, err)


def test_ssd_chunk_invariance():
    """The port's scan gives the same output at any chunk, with and
    without an initial state (``tests/test_models.py``'s check)."""
    x, dt, a, bm, cm, s0 = _ssd_inputs(seed=1)
    args = [_t(v) for v in (x, dt, a, bm, cm)]
    for init in (None, _t(s0)):
        y64, s64 = t_ssm.ssd_chunked(*args, chunk=64, init_state=init)
        for chunk in (8, 16, 32):
            y, s = t_ssm.ssd_chunked(*args, chunk=chunk, init_state=init)
            _close(y.numpy(), y64.numpy(), LOOSE, f"y, chunk {chunk}")
            _close(s.numpy(), s64.numpy(), LOOSE, f"state, chunk {chunk}")


def test_ssd_step_matches_reference_and_the_chunked_scan():
    """One ``ssd_step`` against the reference's; and S steps from the
    initial state against ``ssd_chunked`` over the same S positions."""
    x, dt, a, bm, cm, s0 = _ssd_inputs(seed=2)
    args = lambda t, f: (f(s0), f(x[:, t]), f(dt[:, t]), f(a), f(bm[:, t]),
                         f(cm[:, t]))
    yj, sj = j_ssm.ssd_step(*args(0, jnp.asarray))
    yt, st = t_ssm.ssd_step(*args(0, _t))
    _close(yt.numpy(), yj, CLOSE, "y")
    _close(st.numpy(), sj, CLOSE, "state")
    state, ys = _t(s0), []
    for t in range(x.shape[1]):
        y, state = t_ssm.ssd_step(state, *args(t, _t)[1:])
        ys.append(y)
    yc, sc = t_ssm.ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm)),
                               chunk=16, init_state=_t(s0))
    _close(torch.stack(ys, 1).numpy(), yc.numpy(), LOOSE, "y")
    _close(state.numpy(), sc.numpy(), LOOSE, "state")


def test_ssd_computes_in_float64_for_float64_inputs():
    """The scan and its step keep float32 internals for float32 and bf16
    inputs (y in the input's dtype, the state float32) and compute in
    float64 for float64 inputs, the witness ``chip_smoke.py`` phase 16 (a)
    holds the card to; the two agree within ``LOOSE``."""
    x, dt, a, bm, cm, s0 = _ssd_inputs(seed=7)
    args32 = [_t(v) for v in (x, dt, a, bm, cm)]
    y32, st32 = t_ssm.ssd_chunked(*args32, chunk=16, init_state=_t(s0))
    yb, stb = t_ssm.ssd_chunked(args32[0].bfloat16(), *args32[1:], chunk=16)
    assert (y32.dtype, st32.dtype) == (torch.float32, torch.float32)
    assert (yb.dtype, stb.dtype) == (torch.bfloat16, torch.float32)
    y64, st64 = t_ssm.ssd_chunked(*(v.double() for v in args32), chunk=16,
                                  init_state=_t(s0).double())
    assert (y64.dtype, st64.dtype) == (torch.float64, torch.float64)
    _close(y32.numpy(), y64.numpy(), LOOSE, "y")
    _close(st32.numpy(), st64.numpy(), LOOSE, "state")
    assert not torch.equal(y32.double(), y64)          # not a float32 pass
    ys, ss = t_ssm.ssd_step(_t(s0).double(), *(_t(v[:, 0]).double() for v in
                                               (x, dt)), _t(a).double(),
                            *(_t(v[:, 0]).double() for v in (bm, cm)))
    assert (ys.dtype, ss.dtype) == (torch.float64, torch.float64)


def test_causal_conv_and_conv_step_match_reference():
    """``causal_conv`` against the reference's; ``conv_step`` over the
    positions one by one against the reference's step (outputs and
    buffers) and against ``causal_conv``."""
    rng = np.random.default_rng(3)
    b, s, c, w = 2, 10, 24, 4
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    cw = (0.3 * rng.standard_normal((w, c))).astype(np.float32)
    cb = (0.1 * rng.standard_normal(c)).astype(np.float32)
    yj = j_ssm.causal_conv(jnp.asarray(x), jnp.asarray(cw), jnp.asarray(cb))
    yt = t_ssm.causal_conv(_t(x), _t(cw), _t(cb))
    _close(yt.numpy(), yj, CLOSE, "causal_conv")
    jbuf = jnp.zeros((b, w - 1, c), jnp.float32)
    tbuf = torch.zeros(b, w - 1, c)
    for t in range(s):
        oj, jbuf = j_ssm.conv_step(jnp.asarray(x[:, t]), jbuf,
                                   jnp.asarray(cw), jnp.asarray(cb))
        ot, tbuf = t_ssm.conv_step(_t(x[:, t]), tbuf, _t(cw), _t(cb))
        _close(ot.numpy(), oj, CLOSE, f"conv_step {t}")
        np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
        _close(ot.numpy(), yt[:, t].numpy(), CLOSE, f"step {t} vs conv")


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

def _layer0(tree):
    """Layer 0's ssm weights and adapters, numpy."""
    p = {k: v[0] for k, v in tree["layers"]["ssm"].items()}
    ad = {t: {k: v[0] for k, v in a.items()} for t, a in tree["lora"].items()}
    return p, ad


def test_mixer_and_mixer_step_match_reference(cfgs, tree):
    """``mamba_mixer`` (chunk 8: four chunks of 32 positions) with
    adapters at ranks 3 (``ssm_in``) and 6 (``ssm_out``) against the
    reference's; then ``mamba_mixer_step`` over the positions against the
    reference's step (outputs, conv buffer and state) and against the
    port's own mixer."""
    jcfg, tcfg = cfgs
    p, ad = _layer0(tree)
    x = (0.5 * np.random.default_rng(4).standard_normal(
        (2, SEQ, tcfg.d_model))).astype(np.float32)
    jp, jad = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, ad)
    tp, tad = interop.tree_from_numpy(p, "cpu"), interop.tree_from_numpy(
        ad, "cpu")
    yj = j_ssm.mamba_mixer(jnp.asarray(x), jp, jcfg, jad, chunk=8)
    yt = t_ssm.mamba_mixer(_t(x), tp, tcfg, tad, chunk=8)
    _close(yt.numpy(), yj, CLOSE, "mixer")
    plain = t_ssm.mamba_mixer(_t(x), tp, tcfg, None, chunk=8)
    assert float((plain - yt).abs().max()) > 1e-3          # adapters act
    jc = {k: v[0] for k, v in j_ssm.init_ssm_cache(jcfg, 1, 2,
                                                   jnp.float32).items()}
    tc = {k: v[0] for k, v in t_ssm.init_ssm_cache(tcfg, 1, 2,
                                                   torch.float32).items()}
    for t in range(SEQ):
        oj, jc = j_ssm.mamba_mixer_step(jnp.asarray(x[:, t:t + 1]), jc, jp,
                                        jcfg, jad)
        ot, tc = t_ssm.mamba_mixer_step(_t(x[:, t:t + 1]), tc, tp, tcfg, tad)
        _close(ot.numpy(), oj, CLOSE, f"step {t}")
        _close(ot[:, 0].numpy(), yt[:, t].numpy(), LOOSE, f"step {t} vs "
               f"mixer")
    _close(tc["conv"].numpy(), jc["conv"], CLOSE, "conv buffer")
    _close(tc["state"].numpy(), jc["state"], CLOSE, "state")


def _unclamped_intra(x, dt, a, bm, cm):
    """The intra-chunk term with the exp taken before the mask, as a
    careless port would write it: the upper triangle overflows to inf,
    the mask makes the forward finite, and the backward gives inf * 0."""
    cum = torch.cumsum(dt * a, dim=1)
    c = x.shape[1]
    causal = (torch.arange(c)[:, None] >= torch.arange(c)[None, :])[
        None, :, :, None]
    ldec = torch.where(causal, torch.exp(cum[:, :, None] - cum[:, None]),
                       torch.zeros(()))
    m = torch.einsum("bin,bjn->bij", cm, bm)[..., None] * ldec \
        * dt[:, None]
    return torch.einsum("bijh,bjhp->bihp", m, x)


def test_large_dt_gives_a_finite_gradient():
    """dt ~ 20 and a ~ -5 give upper-triangle exponents up to ~1500 in a
    chunk of 16: exp overflows there. The clamp before exp keeps y and
    every gradient finite; the same term with exp before the mask gives a
    finite forward and a NaN gradient, so the inputs do reach the trap."""
    x, _, _, bm, cm, _ = _ssd_inputs(seed=5, s=16)
    dt = np.full(x.shape[:3], 20.0, np.float32)
    a = np.full(x.shape[2], -5.0, np.float32)
    leaves = [_t(v).requires_grad_(True) for v in (x, dt, a, bm, cm)]
    y, state = t_ssm.ssd_chunked(*leaves, chunk=16)
    grads = torch.autograd.grad(y.square().sum() + state.square().sum(),
                                leaves)
    assert bool(y.isfinite().all()) and bool(state.isfinite().all())
    for name, g in zip(("x", "dt", "a", "B", "C"), grads):
        assert bool(g.isfinite().all()), name
    leaves = [_t(v).requires_grad_(True) for v in (x, dt, a, bm, cm)]
    bad = _unclamped_intra(*leaves)
    assert bool(bad.isfinite().all())
    g_bad = torch.autograd.grad(bad.square().sum(), leaves[1])[0]
    assert not bool(g_bad.isfinite().all())


def test_chunk_must_divide_the_sequence():
    """S = 20 in chunks of 8: the port raises ``ValueError`` (the reference
    asserts); a chunk longer than S is cut to S."""
    x, dt, a, bm, cm, _ = _ssd_inputs(seed=6, s=20)
    with pytest.raises(ValueError, match="20 % chunk 8"):
        t_ssm.ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm)), chunk=8)
    with pytest.raises(AssertionError):
        j_ssm.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)),
                          chunk=8)
    y, _ = t_ssm.ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm)), chunk=64)
    y20, _ = t_ssm.ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm)),
                               chunk=20)
    assert torch.equal(y, y20)


# ---------------------------------------------------------------------------
# the model: init, forward, loss and gradients, decode
# ---------------------------------------------------------------------------

def test_init_params_and_init_cache_shapes_and_dtypes(cfgs):
    """The port's own init has the reference's leaves, shapes and dtypes
    (the SSM scalars float32 under a bf16 model), zero norms and the
    reference's distributions; ``init_cache``'s conv window takes the
    cache dtype, its state float32, as the reference's."""
    jcfg, tcfg = cfgs
    jtree = jax.tree.map(np.asarray, j_model.init_params(
        jax.random.PRNGKey(0), jcfg))
    p = t_model.init_params(tcfg, seed=0, device="cpu")
    got, want = _flat_np({k: v for k, v in p.tree().items()}), _flat_np(jtree)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].shape == w.shape and got[path].dtype == w.dtype, path
    assert p.groups == ("ln1", "ssm") and p.lm_head is None
    ssm = p.layers["ssm"]
    # log of 1..16 spread over the heads: jnp's linspace and log round
    # differently from torch's in the last bit
    np.testing.assert_allclose(ssm.A_log.numpy(),
                               want[("layers", "ssm", "A_log")], rtol=1e-6)
    for name in ("D", "dt_bias", "conv_b", "ssm_norm"):
        np.testing.assert_array_equal(getattr(ssm, name).numpy(),
                                      want[("layers", "ssm", name)])
    assert not p.layers["ln1"].w.any() and not p.final_norm.w.any()
    for name, std in (("in_proj", tcfg.d_model ** -0.5),
                      ("out_proj", tcfg.d_inner ** -0.5), ("conv_w", 0.1)):
        assert abs(float(getattr(ssm, name).std()) / std - 1.0) < 0.05, name
    bf = t_model.init_params(tcfg, seed=0, dtype=torch.bfloat16,
                             device="cpu")
    for name in t_ssm.FLOAT32_LEAVES:
        assert getattr(bf.layers["ssm"], name).dtype == torch.float32
    assert bf.layers["ssm"].in_proj.dtype == torch.bfloat16
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        tc = t_model.init_cache(tcfg, 3, 16, dtype, device="cpu")
        jc = j_model.init_cache(jcfg, 3, 16, jdtype)
        assert sorted(tc) == sorted(jc) == ["conv", "state"]
        for k in tc:
            assert tuple(tc[k].shape) == jc[k].shape, k
            assert str(tc[k].dtype).split(".")[1] == str(jc[k].dtype), k
            assert not tc[k].any()
    L, di, n = tcfg.num_layers, tcfg.d_inner, tcfg.ssm_state
    assert tc["conv"].shape == (L, 3, 3, di + 2 * n)
    assert tc["state"].shape == (L, 3, tcfg.ssm_heads, tcfg.ssm_head_dim, n)


def _batch(cfg, rows=3, seed=9):
    data = make_bigram_lm(rows, SEQ, cfg.vocab_size, seed=seed)
    labels = data["labels"].copy()
    labels[:, -2:] = -1                 # a few positions not scored
    return {"tokens": data["tokens"], "labels": labels}


_J_VALUE_AND_GRAD = jax.jit(
    jax.value_and_grad(j_model.loss_fn, has_aux=True),
    static_argnames=("cfg", "remat"))


@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_and_every_gradient_match_jax(cfgs, tree, remat):
    """The logits, the LM loss and its metrics (aux a float32 zero), and
    the gradient of every leaf (embedding, norms, every ssm weight, the
    LoRA factors and masks) against ``jax.value_and_grad`` of the
    reference's ``loss_fn``. At 32 tokens the scan is one chunk: the
    carry's gradients are held by
    ``test_ssd_chunked_gradients_match_reference``."""
    jcfg, tcfg = cfgs
    batch = _batch(tcfg)
    (total_j, m_j), grads_j = _J_VALUE_AND_GRAD(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch),
        cfg=jcfg, remat=remat)
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = t_model.forward(params, tb, tcfg, remat=remat)
        total_t, m_t = t_model.loss_fn(params, tb, tcfg, remat=remat)
    jl, _ = j_model.forward(jax.tree.map(jnp.asarray, tree),
                            {"tokens": jnp.asarray(batch["tokens"])}, jcfg,
                            remat=False)
    _close(logits.numpy(), jl, CLOSE, "logits")
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    assert sorted(m_t) == sorted(m_j) == ["aux", "loss", "nll"]
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5,
                                   err_msg=k)
    loss_t, grads_t = t_sim.pretrain_loss_and_grads(params.tree(), tb, tcfg,
                                                    remat=remat)
    np.testing.assert_allclose(float(loss_t), float(total_j), rtol=1e-5)
    got, want = _flat_np(grads_t), _flat_np(grads_j)
    assert sorted(got) == sorted(want)
    # A_log alone, by name, is held to A_LOG_REL: its gradient nearly
    # cancels (the module docstring gives the numbers)
    for path, w in want.items():
        g = got[path]
        assert np.isfinite(g).all(), path
        norm = np.linalg.norm(w.astype(np.float64))
        assert norm > 0, path
        err = np.linalg.norm((g - w).astype(np.float64)) / norm
        limit = A_LOG_REL if path[-1] == "A_log" else GRAD_REL
        if path[-1] == "A_log":
            print(f"A_log gradient: norm {norm:.3e}, port against the "
                  f"reference {err:.3e} of it (limit {limit:g})")
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


def test_decode_matches_reference_and_forward(cfgs, tree):
    """12 ``decode_step`` calls from ``init_cache`` (float32) against the
    reference's decode (the logits, then the whole cache) and against the
    port's own ``forward`` over the same tokens."""
    jcfg, tcfg = cfgs
    toks = _batch(tcfg, rows=2)["tokens"]
    jtree = jax.tree.map(jnp.asarray, tree)
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    with torch.no_grad():
        full, _ = t_model.forward(params, {"tokens": _t(toks)}, tcfg,
                                  remat=False)
    scale = float(full.abs().max())
    jcache = j_model.init_cache(jcfg, 2, SEQ, jnp.float32)
    tcache = t_model.init_cache(tcfg, 2, SEQ, torch.float32, device="cpu")
    step = jax.jit(j_model.decode_step, static_argnames=("cfg",))
    for t in range(12):
        jl, jcache = step(jtree, jcache, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t), cfg=jcfg)
        tl, tcache = t_model.decode_step(params, tcache, _t(toks[:, t:t + 1]),
                                         t, tcfg)
        assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) \
            <= DECODE_REL * scale, t
        assert float((tl - full[:, t]).abs().max()) <= DECODE_REL * scale, t
    for k in ("conv", "state"):
        _close(tcache[k].numpy(), jcache[k], CLOSE, k)


# ---------------------------------------------------------------------------
# the client trainers
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
    data = make_bigram_lm(clients * steps * rows, SEQ, cfg.vocab_size,
                          seed=seed)
    return {k: v.reshape(clients, steps, rows, SEQ) for k, v in data.items()}


def test_local_train_matches_reference(cfgs):
    """2 steps of ``make_local_train`` (4 x 32 next-token rows each, ranks
    3 and 6) from the reference's weights against the reference's
    trainer: the mean loss and the trained factors; masked rank
    directions stay bit-unchanged."""
    jcfg, tcfg = cfgs
    tree = _tree(seed=1, ranks={"ssm_in": 3, "ssm_out": 6})
    masks = {t: ad["mask"] for t, ad in tree["lora"].items()}
    trainable = _trainable(tree)
    data = {k: v[0] for k, v in _lm_data(tcfg, 1, 2, 4, seed=2).items()}
    jfrozen, _ = j_client.split_head(jax.tree.map(jnp.asarray, tree))
    jtr, jloss = j_client.make_local_train(jcfg, j_opt.adamw(LR))(
        jfrozen, jax.tree.map(jnp.asarray, trainable),
        jax.tree.map(jnp.asarray, masks), jax.tree.map(jnp.asarray, data))
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    tfrozen, head = split_head(params)
    assert head == {} and sorted(split_adapters(params.lora)[0]) == [
        "ssm_in", "ssm_out"]
    ttr, tloss = make_local_train(tcfg, t_opt.adamw(LR), device="cpu")(
        tfrozen, interop.tree_from_numpy(trainable, "cpu"),
        interop.tree_from_numpy(masks, "cpu"), data)
    np.testing.assert_allclose(float(tloss), float(jloss), **FWD)
    got = interop.tree_to_numpy(ttr)
    _hold_trained(got, jax.tree.map(np.asarray, jtr), trainable)
    for t, r in (("ssm_in", 3), ("ssm_out", 6)):
        np.testing.assert_array_equal(got["factors"][t]["A"][..., r:],
                                      trainable["factors"][t]["A"][..., r:])
        np.testing.assert_array_equal(got["factors"][t]["B"][..., r:, :],
                                      trainable["factors"][t]["B"][..., r:,
                                                                   :])


def test_cohort_train_matches_reference_vmap(cfgs):
    """One step each of a 3-client cohort at ranks 2, 4 and 8 (both
    targets) through ``make_cohort_train`` against the reference's vmapped
    trainer: the per-client losses and every client's trained factors."""
    jcfg, tcfg = cfgs
    ranks = (2, 4, 8)
    tree = _tree(seed=2)
    trainable = jax.tree.map(lambda a: np.stack([a] * len(ranks)),
                             _trainable(tree))
    per = [_masks(jcfg, {t: r for t in jcfg.lora.targets}, seed=7 + i)
           for i, r in enumerate(ranks)]
    masks = {t: np.stack([m[t] for m in per]) for t in jcfg.lora.targets}
    data = _lm_data(tcfg, len(ranks), 1, 4, seed=3)
    jfrozen, _ = j_client.split_head(jax.tree.map(jnp.asarray, tree))
    jtr, jloss = j_client.make_cohort_train(jcfg, j_opt.adamw(LR))(
        jfrozen, jax.tree.map(jnp.asarray, trainable),
        jax.tree.map(jnp.asarray, masks), jax.tree.map(jnp.asarray, data))
    tfrozen, _ = split_head(interop.params_from_jax(tree, tcfg,
                                                    device="cpu"))
    ttr, tloss = make_cohort_train(tcfg, t_opt.adamw(LR), device="cpu")(
        tfrozen, interop.tree_from_numpy(trainable, "cpu"),
        interop.tree_from_numpy(masks, "cpu"), data)
    assert tloss.shape == (len(ranks),)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **FWD)
    _hold_trained(interop.tree_to_numpy(ttr), jax.tree.map(np.asarray, jtr),
                  trainable)


# ---------------------------------------------------------------------------
# the LM example, interop, serving
# ---------------------------------------------------------------------------

def test_lm_example_matches_the_reference_example(monkeypatch, tmp_path):
    """``--arch mamba2-2.7b``: 5 steps of the reference example's own loop
    at mamba2-reduced (16 x 64 tokens: one SSD chunk of 64) against the
    port's ``train`` from the same weights and data (each loss, every
    trained leaf; ``tests/test_torch_lm.py``'s limits)."""
    _hold_train_against_reference_example(
        monkeypatch, tmp_path, _example("lm_pretrain_torch",
                                        "lm_pretrain_torch.py"), ARCH)


def test_lm_example_main_runs_mamba2_on_the_cpu():
    """``main(["--arch", "mamba2-2.7b", "--device", "cpu", ...])`` takes
    the reduced config and gives ``train``'s losses from the port's own
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


def test_interop_keeps_the_ssm_scalars_float32(cfgs, tree):
    """``params_from_jax(..., dtype=torch.bfloat16)``: ``A_log``, ``D`` and
    ``dt_bias`` stay float32 and bit-equal, every other weight is bf16;
    the tree goes back through ``tree_to_numpy`` unchanged (float32)."""
    _, tcfg = cfgs
    bf = interop.params_from_jax(tree, tcfg, device="cpu",
                                 dtype=torch.bfloat16)
    ssm = bf.layers["ssm"].as_dict()
    for name, t in ssm.items():
        if name in t_ssm.FLOAT32_LEAVES:
            assert t.dtype == torch.float32, name
            np.testing.assert_array_equal(t.numpy(),
                                          tree["layers"]["ssm"][name])
        else:
            assert t.dtype == torch.bfloat16, name
    assert bf.embed.dtype == bf.layers["ln1"].w.dtype == torch.bfloat16
    f32 = interop.params_from_jax(tree, tcfg, device="cpu")
    back = _flat_np(interop.tree_to_numpy(f32.tree()))
    for path, w in _flat_np(tree).items():
        np.testing.assert_array_equal(back[path], w)


def test_serve_engine_refuses_ssm(cfgs):
    """The engine serves the dense family only, as the reference's does
    (both raise ``NotImplementedError`` on the Mamba2 config; the
    registry takes its ``ssm_in`` and ``ssm_out`` adapters): Mamba2
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
