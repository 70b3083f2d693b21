"""Backbone pretraining in the port against the reference's, on the CPU.

The reference trains every tensor of its backbone (``jax.value_and_grad``
over the whole ``params`` tree, the LoRA masks included) before the
federated run; the port does the same through ``core.lora.apply_lora``,
whose autograd Function now also returns dW0 = x^T dy and the scale's
gradient. Both sides start from the reference's own weights
(``repro.models.model.init_params`` on ``roberta-reduced``: 2 layers,
d_model 128, LoRA on q and v at r_max 8), carried over by
``repro_torch.interop``; the port's ``init_params`` is patched to return
them. Inputs come from numpy.

Tolerances, float32 throughout:
- one op's output: rtol 1e-4, atol 1e-5 (the same float32 products summed
  in another order, values O(1));
- gradients: rtol 1e-4, atol 1e-5 of the largest entry of the leaf (the
  same reordering; entries range over orders of magnitude, so the floor
  scales with the leaf), as in ``tests/test_torch_train.py``;
- pretraining losses, step by step: 1e-5 absolute (O(1) values, the
  forward's reordering through two layers and 4 or 20 Adam steps);
- pretrained leaves: normwise, ||port - ref|| <= ``CHANGE_REL`` (1e-3)
  of ||ref - initial||, the change the steps made. Adam's first steps move
  an element by about lr * sign(g), so an element whose gradient is within
  rounding of zero may move the other way on one side; a missed or wrong
  update is of the order of the change itself. Exact zeros (the gradient
  of embedding rows no batch reached; of A and the mask while B = 0, as on
  the first step) must be exact on both sides;
- the key bias ``bk``, whose gradient is zero in exact arithmetic (q·bk is
  added to every score of a query's row, which the softmax cancels): both
  sides' gradients are rounding noise, held to ``NOISE_REL`` (1e-5) of the
  largest entry of ``bq``'s gradient, and Adam turns that noise into steps
  of about lr either way, so its pretrained change is held to Adam's bound
  (|Δ| <= steps · lr · 1.01 per element) on both sides, not compared;
- the federated run from the pretrained backbone: ``tests/
  test_torch_session.py``'s anchored tolerances (losses rtol 1e-4 / atol
  1e-5, the effective global update 1e-4 normwise, spectra rtol 1e-4, eval
  accuracy equal up to examples whose reference logit margin is below
  1e-3); its integers (cohorts, ranks, bytes, health rows) equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core import agg_engine as j_engine
from repro.core import lora as j_lora
from repro.core.seeds import derive_seed as j_derive_seed
from repro.data import make_pair_classification as j_pairs
from repro.fed import schedulers as j_sched
from repro.fed import session as j_session
from repro.fed import simulation as j_sim
from repro.models import model as j_model
from repro_torch import interop
from repro_torch.configs import get_reduced
from repro_torch.core import lora as t_lora
from repro_torch.fed import schedulers as t_sched
from repro_torch.fed import session as t_session
from repro_torch.fed import simulation as t_sim
from repro_torch.models import model as t_model
from repro_torch.models.transformer import Transformer
from repro_torch.optim.optimizers import tree_leaves
from test_torch_session import (LOSS, SERVER, SIM, _hold_eval,
                                _hold_integers, _hold_round, _initial_lora,
                                _recording)

FWD = dict(rtol=1e-4, atol=1e-5)
LOSS_ATOL = 1e-5
CHANGE_REL = 1e-3
NOISE_REL = 1e-5
BK, BQ = ("layers", "attn", "bk"), ("layers", "attn", "bq")
PRETRAIN = dict(num_examples=256, pretrain_steps=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread avoids thread-pool
    overhead and contention with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_caches():
    """Both packages cache backbones by a key without ``num_examples``:
    every test starts and ends with empty caches (the reference's own
    entries put back after)."""
    saved = dict(j_sim._PRETRAIN_STORE)
    j_sim._PRETRAIN_STORE.clear()
    t_sim._PRETRAIN_STORE.clear()
    yield
    t_sim._PRETRAIN_STORE.clear()
    j_sim._PRETRAIN_STORE.clear()
    j_sim._PRETRAIN_STORE.update(saved)


@pytest.fixture(scope="module")
def ref():
    jcfg, tcfg = j_get_reduced("roberta-large"), get_reduced("roberta-large")
    jparams = j_model.init_params(jax.random.PRNGKey(0), jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                np=jax.tree.map(np.asarray, jparams))


@pytest.fixture
def patched_init(ref, monkeypatch):
    """The port's ``init_params`` returns the reference's seed-0 weights."""
    def init(cfg, seed=0, dtype=torch.float32, device=None):
        assert seed == 0
        return interop.params_from_jax(ref["np"], cfg, device=device)
    monkeypatch.setattr(t_sim.model_lib, "init_params", init)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _grad_close(got, want, what=""):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max(), err_msg=what)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _paths(tree[k], prefix + (k,)).items()}
    return {prefix: tree}


def _flat_np(tree):
    return {p: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for p, v in _paths(tree).items()}


# ---------------------------------------------------------------------------
# (1), (2) apply_lora with W0 and the mask trainable
# ---------------------------------------------------------------------------

# masks of r_max 8: binary at rank 4; non-binary (a trained mask) with
# rank directions 5-7 off; and one summing to exactly 1, where the scale's
# max(Σ m, 1) sits on its tie
MASKS = {"binary-r4": [1, 1, 1, 1, 0, 0, 0, 0],
         "trained-r5": [0.9, 1.1, 1.02, 0.97, 1.3, 0, 0, 0],
         "tie-sum-one": [0.25, 0.5, 0.25, 0, 0, 0, 0, 0]}


@pytest.mark.parametrize("stack", [(), (3,)], ids=["2d", "stacked"])
@pytest.mark.parametrize("mask", list(MASKS))
def test_apply_lora_w0_and_mask_gradients_match_jax_vjp(mask, stack):
    rng = np.random.default_rng(len(mask) + len(stack))
    live = np.asarray(MASKS[mask]) != 0
    m = np.broadcast_to(np.asarray(MASKS[mask], np.float32),
                        (*stack, 8)).copy()
    rows = (10,) if stack else (2, 5)   # a stacked adapter: one per entry
    x = rng.standard_normal((*stack, *rows, 24), dtype=np.float32)
    w0 = (rng.standard_normal((*stack, 24, 20)) / np.sqrt(24)).astype(
        np.float32)
    a = rng.standard_normal((*stack, 24, 8), dtype=np.float32) / 5
    b = rng.standard_normal((*stack, 8, 20), dtype=np.float32) / 5
    dy = rng.standard_normal((*stack, *rows, 20), dtype=np.float32)

    def jf(x, w0, a, b, m):
        return j_lora.apply_lora(x, w0, {"A": a, "B": b, "mask": m}, 16.0)

    y_j, vjp = jax.vjp(jf, *map(jnp.asarray, (x, w0, a, b, m)))
    want = vjp(jnp.asarray(dy))

    leaves = [_t(v).requires_grad_(True) for v in (x, w0, a, b, m)]
    xt, w0t, at, bt, mt = leaves
    y_t = t_lora.apply_lora(xt, w0t, {"A": at, "B": bt, "mask": mt}, 16.0)
    got = [g.numpy() for g in torch.autograd.grad(y_t, leaves, _t(dy))]
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **FWD)
    for name, g, w in zip(("x", "W0", "A", "B", "mask"), got, want):
        _grad_close(g, np.asarray(w), f"{mask} d{name}")
    # dW0 is x^T dy; masked rank directions get exactly zero gradient in
    # the factors, and in the mask only the scale's share, d s / d Σ m,
    # which is the same for every direction
    dw0 = np.einsum("...mk,...mn->...kn", x.reshape(*stack, -1, 24),
                    dy.reshape(*stack, -1, 20))
    np.testing.assert_allclose(got[1], dw0, **FWD)
    assert not got[2][..., ~live].any() and not got[3][..., ~live, :].any()
    dead = got[4][..., ~live]
    assert (dead == dead[..., :1]).all() and (dead != 0).all()


def _leaves64(seed, mask):
    gen = torch.Generator().manual_seed(seed)

    def leaf(*shape):
        return torch.randn(*shape, dtype=torch.float64, generator=gen,
                           requires_grad=True)

    x, w0, a, b = leaf(2, 3, 6), leaf(6, 5), leaf(6, 4), leaf(4, 5)
    m = torch.tensor(mask, dtype=torch.float64, requires_grad=True)
    return x, w0, a, b, m


def _apply(x, w0, a, b, m):
    return t_lora.apply_lora(x, w0, {"A": a, "B": b, "mask": m}, 16.0)


def test_apply_lora_gradcheck_w0_and_mask_float64():
    """Finite differences in float64 through the plain path: the
    Function's backward to x, W0, A and B, and the mask's products around
    it. The mask sums to less than 1, so the scale is alpha itself:
    ``_lora_2d`` hands the fused op its scale as float32 (the kernels'
    operand), and any other scale would round there, by more than a
    float64 finite difference can see past. The scale's own path is held
    in the next test."""
    assert torch.autograd.gradcheck(_apply, _leaves64(0, [0.3, 0.2, 0.25,
                                                          0.0]))


def test_apply_lora_scale_gradient_against_float64_autograd():
    """The scale's path (ds = Σ xa g, through max(Σ m, 1) into the mask)
    and every other gradient against float64 autograd of the same math in
    plain ops, at a mask summing past 1: within 1e-6 of each leaf's
    largest entry (the float32 scale, 6e-8 of itself, and ds rounded to
    it)."""
    leaves = _leaves64(1, [0.9, 1.2, 0.7, 0.0])
    x, w0, a, b, m = leaves
    dy = torch.randn(2, 3, 5, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(2))
    got = torch.autograd.grad(_apply(*leaves), leaves, dy)
    s = 16.0 / torch.maximum(m.sum(), m.new_ones(()))
    y = x @ w0 + s * ((x @ (a * m)) @ (b * m[:, None]))
    want = torch.autograd.grad(y, leaves, dy)
    for name, g, w in zip(("x", "W0", "A", "B", "mask"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 * float(w.abs().max()),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# (3) loss_fn's gradient of every leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state", ["initial", "live"])
def test_loss_fn_gradient_of_every_leaf_matches_jax_grad(ref, state):
    """The whole tree: at the initial weights (B = 0, binary masks: A's and
    the masks' gradients exactly zero on both sides, as on pretraining's
    first step), and with live adapters (small random B, a trained mask)
    so that every product carries signal."""
    jcfg, tcfg = ref["jcfg"], ref["tcfg"]
    rng = np.random.default_rng(2)
    tree = jax.tree.map(np.array, ref["np"])
    if state == "live":
        for ad in tree["lora"].values():
            ad["B"] = (0.05 * rng.standard_normal(ad["B"].shape)).astype(
                np.float32)
            ad["mask"] = (ad["mask"] * rng.uniform(
                0.8, 1.2, ad["mask"].shape)).astype(np.float32)
    tokens, labels = j_pairs("qqp", 12, seed=5, vocab_size=jcfg.vocab_size)
    batch = {"tokens": tokens, "labels": labels}

    def jloss(p):
        return j_model.loss_fn(p, jax.tree.map(jnp.asarray, batch), jcfg,
                               remat=False)[0]

    loss_j, grads_j = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray,
                                                             tree))
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    loss_t, grads_t = t_sim.pretrain_loss_and_grads(
        params.tree(), {k: _t(v) for k, v in batch.items()}, tcfg)
    assert not any(t.requires_grad for t in tree_leaves(params.tree()))
    np.testing.assert_allclose(float(loss_t), float(loss_j), **FWD)
    want, got = _flat_np(grads_j), _flat_np(grads_t)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        if path == BK:
            for side in (got, want):
                assert np.abs(side[BK]).max() <= NOISE_REL * np.abs(
                    side[BQ]).max()
            continue
        _grad_close(got[path], w, "/".join(path))
        assert np.array_equal(got[path] == 0, w == 0), path
    unused = np.setdiff1d(np.arange(jcfg.vocab_size), tokens)
    assert unused.size and not want[("embed",)][unused].any()
    zero = [p for p in want if p[0] == "lora" and p[2] in ("A", "mask")]
    assert all(not got[p].any() for p in zero) == (state == "initial")


# ---------------------------------------------------------------------------
# (4) the pretraining batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_pretrain_batches_identical(ref, seed):
    cfg = ref["tcfg"]
    sim = t_sim.SimConfig(seed=seed, num_examples=300, pretrain_steps=5)
    rng = np.random.default_rng(j_derive_seed(seed, "pretrain-batches"))
    tokens, labels = j_pairs("qqp", 300, seed=seed + 777,
                             vocab_size=cfg.vocab_size)
    got = list(t_sim.pretrain_batches(cfg, sim))
    assert len(got) == 5
    for batch in got:
        picks = rng.integers(0, len(tokens), size=64)
        assert np.array_equal(batch["tokens"], tokens[picks])
        assert np.array_equal(batch["labels"], labels[picks])
        assert batch["tokens"].dtype == tokens.dtype


# ---------------------------------------------------------------------------
# (5) pretrain_backbone
# ---------------------------------------------------------------------------

def _reference_pretrain(ref, monkeypatch, **sim):
    """The reference's ``pretrain_backbone`` with each step's loss logged
    from inside its jitted step."""
    losses, loss_fn = [], j_model.loss_fn

    def logged(*args, **kw):
        loss, m = loss_fn(*args, **kw)
        jax.debug.callback(lambda v: losses.append(float(v)), loss)
        return loss, m

    monkeypatch.setattr(j_sim.model_lib, "loss_fn", logged)
    params = j_sim.pretrain_backbone(ref["jcfg"], j_sim.SimConfig(**sim))
    monkeypatch.setattr(j_sim.model_lib, "loss_fn", loss_fn)
    return jax.tree.map(np.asarray, params), losses


def _port_pretrain(ref, monkeypatch, **sim):
    losses, step = [], t_sim.pretrain_loss_and_grads

    def logged(*args):
        loss, grads = step(*args)
        losses.append(float(loss))
        return loss, grads

    monkeypatch.setattr(t_sim, "pretrain_loss_and_grads", logged)
    params = t_sim.pretrain_backbone(ref["tcfg"], t_sim.SimConfig(**sim),
                                     device="cpu")
    monkeypatch.setattr(t_sim, "pretrain_loss_and_grads", step)
    return params, losses


def _hold_pretrain(ref, monkeypatch, sim):
    """Both sides' ``pretrain_backbone`` under ``sim``: each step's loss,
    every leaf against the reference's change, exact zeros, the masks."""
    want, jlosses = _reference_pretrain(ref, monkeypatch, **sim)
    params, tlosses = _port_pretrain(ref, monkeypatch, **sim)
    assert isinstance(params, Transformer)
    assert not any(t.requires_grad for t in tree_leaves(params.tree()))
    assert len(tlosses) == len(jlosses) == sim["pretrain_steps"]
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=LOSS_ATOL)
    init, want, got = _flat_np(ref["np"]), _flat_np(want), \
        _flat_np(params.tree())
    assert sorted(got) == sorted(want)
    steps, lr = sim["pretrain_steps"], t_sim.SimConfig().pretrain_lr
    for path, w in want.items():
        change = w.astype(np.float64) - init[path]
        assert np.linalg.norm(change) > 0, path      # every leaf trained
        if path == BK:                               # noise, both sides
            for side in (got, want):
                assert np.abs(side[BK] - init[BK]).max() <= steps * lr * 1.01
            continue
        diff = np.linalg.norm(got[path].astype(np.float64) - w)
        assert diff <= CHANGE_REL * np.linalg.norm(change), (path, diff)
    # embedding rows no batch reached stay bit-unchanged on both sides
    seen = np.unique(np.concatenate([b["tokens"].ravel() for b in
                                     t_sim.pretrain_batches(
                                         ref["tcfg"], t_sim.SimConfig(
                                             **sim))]))
    unseen = np.setdiff1d(np.arange(ref["tcfg"].vocab_size), seen)
    for side in (got, want):
        assert np.array_equal(side[("embed",)][unseen],
                              init[("embed",)][unseen])
        assert (side[("embed",)][seen] != init[("embed",)][seen]).any(1).all()
    # the masks are trained and no longer binary
    assert not np.isin(got[("lora", "q", "mask")], (0.0, 1.0)).all()


def test_pretrain_backbone_matches_reference(ref, patched_init, monkeypatch):
    _hold_pretrain(ref, monkeypatch, PRETRAIN)


def test_pretrain_backbone_matches_reference_over_20_steps(
        ref, patched_init, monkeypatch):
    """Past the loss spike that Adam's first steps at lr 1e-3 cause
    (step 1's loss several times step 0's, on both sides) and its decay,
    at the same tolerances."""
    _hold_pretrain(ref, monkeypatch, dict(PRETRAIN, pretrain_steps=20))


# ---------------------------------------------------------------------------
# (6) the cache
# ---------------------------------------------------------------------------

def test_pretrain_cache_and_zero_steps(ref):
    cfg = ref["tcfg"]
    sim = t_sim.SimConfig(num_examples=64, pretrain_steps=1)
    first = t_sim.pretrain_backbone(cfg, sim, device="cpu")
    assert t_sim.pretrain_backbone(cfg, sim, device="cpu") is first
    # num_examples is not in the key, as in the reference
    assert t_sim.pretrain_backbone(cfg, t_sim.SimConfig(
        num_examples=128, pretrain_steps=1), device="cpu") is first
    assert list(t_sim._PRETRAIN_STORE) == [
        (cfg.name, 0, 1, sim.pretrain_lr, "cpu")]
    for other in (dict(pretrain_steps=2), dict(pretrain_lr=1e-4),
                  dict(seed=1)):
        again = t_sim.pretrain_backbone(cfg, t_sim.SimConfig(
            **dict(dict(num_examples=64, pretrain_steps=1), **other)),
            device="cpu")
        assert again is not first, other
    zero = t_sim.pretrain_backbone(cfg, t_sim.SimConfig(pretrain_steps=0),
                                   device="cpu")
    init = _paths(t_model.init_params(cfg, 0, device="cpu").tree())
    got = _paths(zero.tree())
    assert sorted(got) == sorted(init)
    for path, want in init.items():
        assert torch.equal(got[path], want), path


def test_pretrain_cache_keys_the_device(ref, monkeypatch):
    """Another device is another entry: a backbone on the CPU is never
    handed to a caller on the card. (Resolving a CUDA device needs a card,
    so the key is read from the store.)"""
    calls = []

    def init(cfg, seed=0, dtype=torch.float32, device=None):
        calls.append(device)
        return interop.params_from_jax(ref["np"], cfg, device="cpu")

    monkeypatch.setattr(t_sim.model_lib, "init_params", init)
    cfg, sim = ref["tcfg"], t_sim.SimConfig(pretrain_steps=0)
    t_sim.pretrain_backbone(cfg, sim, device="cpu")
    t_sim.pretrain_backbone(cfg, sim, device=torch.device("cpu"))
    assert calls == [torch.device("cpu")]
    t_sim._PRETRAIN_STORE[(cfg.name, 0, 0, sim.pretrain_lr, "cuda:0")] = \
        "card"
    assert t_sim.pretrain_backbone(cfg, sim, device="cpu") != "card"
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# (7) run_experiment and run_centralized with base_params=None
# ---------------------------------------------------------------------------

def test_run_experiment_pretrains_and_matches_reference(ref, patched_init):
    """hlora factored, 2 rounds, both sides pretraining their own backbone
    from the same initial weights: integers in a free run, floats in every
    round of a run anchored to the reference's state (``tests/
    test_torch_session.py``)."""
    sim = dict(SIM, rounds=2, **PRETRAIN)
    server = dict(SERVER, strategy="hlora")
    jsched = _recording(j_sched.SyncRound)
    jhist = j_sim.run_experiment(
        ref["jcfg"], j_sim.SimConfig(**sim), j_session.ServerConfig(**server),
        engine=j_engine.AggregationEngine(use_pallas=False), scheduler=jsched)
    assert len(j_sim._PRETRAIN_STORE) == 1
    weights = dict(ref, jparams=next(iter(j_sim._PRETRAIN_STORE.values())))
    hists = {}
    for mode, anchors in (("free", None), ("anchored", jsched.log)):
        tsched = _recording(t_sched.SyncRound, _initial_lora(ref, server),
                            anchors)
        hist = t_sim.run_experiment(
            ref["tcfg"], t_sim.SimConfig(**sim),
            t_session.ServerConfig(**server), scheduler=tsched, device="cpu")
        _hold_integers(jhist, jsched.log, hist, tsched.log)
        hists[mode] = (hist, tsched.log)
    assert len(t_sim._PRETRAIN_STORE) == 1          # pretrained once
    free, _ = hists["free"]
    np.testing.assert_allclose(free["train_loss"][0], jhist["train_loss"][0],
                               **LOSS)
    ahist, alog = hists["anchored"]
    np.testing.assert_allclose(ahist["train_loss"], jhist["train_loss"],
                               **LOSS)
    for i in range(len(jsched.log)):
        _hold_round(weights, jsched.log[i], alog[i], f"anchored round {i}")
    _hold_eval(weights, jhist, jsched.log, ahist, range(len(jsched.log)),
               sim)


def test_run_centralized_pretrains_and_matches_reference(ref, patched_init):
    """Two chunks from the pretrained backbone's own LoRA factors, their
    mask reset to rank 4."""
    sim = dict(SIM, rounds=2, **PRETRAIN)
    jhist = j_sim.run_centralized(ref["jcfg"], j_sim.SimConfig(**sim),
                                  rank=4)
    thist = t_sim.run_centralized(ref["tcfg"], t_sim.SimConfig(**sim),
                                  rank=4, device="cpu")
    assert thist["round"] == jhist["round"] == [0, 1]
    for k in ("train_loss", "eval_loss"):
        np.testing.assert_allclose(thist[k], jhist[k], **LOSS)
    assert len(t_sim._PRETRAIN_STORE) == 1
