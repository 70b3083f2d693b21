"""The port's client training against the reference's, on the CPU.

Both sides start from the reference's own RoBERTa encoder weights
(``repro.models.model.init_params`` on ``roberta-reduced``: 2 layers,
d_model 128, LoRA on q and v at r_max 8), carried over by
``repro_torch.interop``, with live adapters and per-client rank masks;
inputs come from the data generators, which must agree bit for bit. On the
CPU every ``lora_matmul`` op runs its plain version, so this holds the
autograd wiring, the encoder, the loss, the optimizer and the trainers to
``jax.grad`` and the reference's trainers; the CUDA kernels are held to
the same plain versions on the card by ``chip_smoke.py``.

Tolerances, float32 throughout:
- forward values (logits, losses, one op's output): rtol 1e-5 / atol
  1e-5 for one product, 1e-4 / 1e-5 through the model: the same float32
  products summed in another order, values O(1);
- gradients: rtol 1e-4, atol 1e-5 of the largest entry of the leaf (the
  same reordering; entries range over orders of magnitude, so the
  absolute floor scales with the leaf);
- trained factors and head, element by element: rtol 1e-4, atol 5e-5
  (= 0.05 lr). Adam divides each gradient by its running RMS plus eps
  (1e-8), so an element whose gradient is within rounding of zero can
  move by a few percent of lr more or less; and, leaf by leaf, the
  difference's norm within 1e-3 of the norm of the reference's change
  (trained minus initial), which such elements cannot reach;
- masked rank directions: exactly zero gradient, bit-unchanged factors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core import lora as j_lora
from repro.data import client_batches as j_client_batches
from repro.data import dirichlet_partition as j_dirichlet
from repro.data import make_pair_classification as j_pairs
from repro.fed import client as j_client
from repro.fed.simulation import SimConfig as JSimConfig
from repro.fed.simulation import _stack_client_data as j_stack
from repro.models import model as j_model
from repro.optim import optimizers as j_opt
from repro.optim import schedules as j_sched
from repro_torch import interop
from repro_torch.configs import get_reduced
from repro_torch.core import lora as t_lora
from repro_torch.data import (client_batches, dirichlet_partition,
                              make_pair_classification)
from repro_torch.fed import (SimConfig, client_params, evaluate,
                             loss_and_grads, make_cohort_train,
                             make_local_train, split_head,
                             stack_client_data)
from repro_torch.models import model as t_model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.recorder import Recorder
from repro_torch.optim import optimizers as t_opt
from repro_torch.optim import schedules as t_sched

FWD = dict(rtol=1e-4, atol=1e-5)
LR = 1e-3
TRAINED = dict(rtol=1e-4, atol=0.05 * LR)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread avoids thread-pool
    overhead and contention with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _masks(cfg, rank):
    m = np.asarray(j_lora.make_rank_mask(rank, cfg.lora.r_max))
    return {t: np.broadcast_to(m, (cfg.num_layers, cfg.lora.r_max)).copy()
            for t in cfg.lora.targets}


@pytest.fixture(scope="module")
def setup():
    """The reference's encoder weights with trained-looking adapters
    (gaussian A, small random B), split into the frozen base and the
    trainable factors and head, on both sides; plus a task's data."""
    jcfg, tcfg = j_get_reduced("roberta-large"), get_reduced("roberta-large")
    key = jax.random.PRNGKey(0)
    jparams = j_model.init_params(key, jcfg)
    rng = np.random.default_rng(1)
    for t, ad in jparams["lora"].items():
        ad["B"] = jnp.asarray(0.05 * rng.standard_normal(ad["B"].shape),
                              jnp.float32)
    jfrozen, jhead = j_client.split_head(jparams)
    jfactors, _ = j_client.split_adapters(jparams["lora"])
    tparams = interop.params_from_jax(_np(jparams), tcfg, device="cpu")
    tfrozen, _ = split_head(tparams)
    tokens, labels = make_pair_classification("mrpc", 96, seed=3,
                                              vocab_size=tcfg.vocab_size)
    trainable = _np({"factors": jfactors, "head": jhead})
    return dict(jcfg=jcfg, tcfg=tcfg, jfrozen=jfrozen, tfrozen=tfrozen,
                trainable=trainable, tokens=tokens, labels=labels)


def _grad_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def _batch(setup, idx):
    return {"tokens": setup["tokens"][idx], "labels": setup["labels"][idx]}


def _jparams(setup, trainable, masks):
    return {**setup["jfrozen"], **trainable["head"],
            "lora": j_client.join_adapters(trainable["factors"], masks)}


# ---------------------------------------------------------------------------
# (2) the autograd Function against jax.vjp of the reference's apply_lora
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", [2, 4, 6, 8])
def test_apply_lora_backward_matches_jax_vjp(rank):
    rng = np.random.default_rng(rank)
    x = rng.standard_normal((2, 5, 24), dtype=np.float32)
    w0 = (rng.standard_normal((24, 20)) / np.sqrt(24)).astype(np.float32)
    ad = {"A": rng.standard_normal((24, 8), dtype=np.float32) / 5,
          "B": rng.standard_normal((8, 20), dtype=np.float32) / 5,
          "mask": np.asarray(j_lora.make_rank_mask(rank, 8))}
    dy = rng.standard_normal((2, 5, 20), dtype=np.float32)

    def jf(x, a, b):
        return j_lora.apply_lora(x, jnp.asarray(w0), {
            "A": a, "B": b, "mask": jnp.asarray(ad["mask"])}, 16.0)

    y_j, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(ad["A"]),
                       jnp.asarray(ad["B"]))
    dx_j, da_j, db_j = vjp(jnp.asarray(dy))

    xt = _t(x).requires_grad_(True)
    at = _t(ad["A"]).requires_grad_(True)
    bt = _t(ad["B"]).requires_grad_(True)
    y_t = t_lora.apply_lora(xt, _t(w0), {"A": at, "B": bt,
                                         "mask": _t(ad["mask"])}, 16.0)
    y_t.backward(_t(dy))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **FWD)
    _grad_close(xt.grad.numpy(), np.asarray(dx_j))
    _grad_close(at.grad.numpy(), np.asarray(da_j))
    _grad_close(bt.grad.numpy(), np.asarray(db_j))
    # masked rank directions get exactly zero gradient
    assert not at.grad[:, rank:].any() and not bt.grad[rank:, :].any()
    assert at.grad[:, :rank].abs().min() > 0


def test_apply_lora_gradcheck_float64():
    """Finite differences in float64 through the plain path: the
    Function's backward (dx, dA, dB) and the mask product around it."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 6, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    w0 = torch.randn(6, 5, dtype=torch.float64, generator=gen)
    a = torch.randn(6, 4, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    b = torch.randn(4, 5, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    mask = t_lora.make_rank_mask(3, 4, torch.float64)
    assert torch.autograd.gradcheck(
        lambda x, a, b: t_lora.apply_lora(x, w0, {"A": a, "B": b,
                                                  "mask": mask}, 16.0),
        (x, a, b))


def test_apply_lora_refuses_a_trainable_w0_and_passes_no_adapter():
    """A trainable W0 (backbone pretraining) is taken, not refused: it
    gets dW0 = x2^T dy over x's rows flattened, and no other input's
    gradient changes; no adapter still gives ``x @ w0``."""
    x, w0 = torch.randn(2, 3, 6), torch.randn(6, 5)
    dy = torch.randn(2, 3, 5)
    ad = {"A": torch.randn(6, 4), "B": torch.randn(4, 5),
          "mask": t_lora.make_rank_mask(2, 4)}
    xt = x.clone().requires_grad_(True)
    y = t_lora.apply_lora(xt, w0, ad, 16.0)
    dx_frozen, = torch.autograd.grad(y, xt, dy)
    wt = w0.clone().requires_grad_(True)
    y = t_lora.apply_lora(xt, wt, ad, 16.0)
    dx, dw0 = torch.autograd.grad(y, (xt, wt), dy)
    assert torch.equal(dx, dx_frozen)
    np.testing.assert_allclose(
        dw0.numpy(), (x.reshape(-1, 6).T @ dy.reshape(-1, 5)).numpy(),
        rtol=1e-5, atol=1e-5)
    assert torch.equal(t_lora.apply_lora(x, w0, None, 16.0), x @ w0)


# ---------------------------------------------------------------------------
# (3), (4) the encoder: logits, loss, accuracy and gradients
# ---------------------------------------------------------------------------

def test_encoder_logits_loss_and_accuracy_match(setup):
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    masks = _masks(jcfg, 6)
    batch = _batch(setup, slice(0, 12))
    jp = _jparams(setup, setup["trainable"], masks)
    logits_j, _ = j_model.forward(jp, batch, jcfg, remat=False)
    loss_j, m_j = j_model.loss_fn(jp, batch, jcfg, remat=False)
    tp = client_params(setup["tfrozen"], interop.tree_from_numpy(
        setup["trainable"], "cpu"), interop.tree_from_numpy(masks, "cpu"))
    tb = {k: _t(v) for k, v in batch.items()}
    logits_t, _ = t_model.forward(tp, tb, tcfg)
    loss_t, m_t = t_model.loss_fn(tp, tb, tcfg)
    assert logits_t.shape == (12, tcfg.num_classes)
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), **FWD)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **FWD)
    assert float(m_t["acc"]) == float(m_j["acc"])
    ev = evaluate(tp, tb, tcfg, device="cpu")
    assert float(ev["loss"]) == float(loss_t)
    assert float(ev["acc"]) == float(m_t["acc"])


@pytest.mark.parametrize("rank", [2, 8])
def test_encoder_gradients_match_jax_grad(setup, rank):
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    masks = _masks(jcfg, rank)
    batch = _batch(setup, slice(12, 28))

    def jloss(trainable):
        return j_model.loss_fn(_jparams(setup, trainable, masks), batch,
                               jcfg, remat=False)[0]

    loss_j, g_j = jax.value_and_grad(jloss)(
        jax.tree.map(jnp.asarray, setup["trainable"]))
    loss_t, g_t = loss_and_grads(
        setup["tfrozen"], interop.tree_from_numpy(setup["trainable"], "cpu"),
        interop.tree_from_numpy(masks, "cpu"),
        {k: _t(v) for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **FWD)
    g_t, g_j = interop.tree_to_numpy(g_t), _np(g_j)
    for name in ("cls_head", "cls_bias"):
        _grad_close(g_t["head"][name], g_j["head"][name])
    for t in jcfg.lora.targets:
        for f in ("A", "B"):
            _grad_close(g_t["factors"][t][f], g_j["factors"][t][f])
        assert not g_t["factors"][t]["A"][:, :, rank:].any()
        assert not g_t["factors"][t]["B"][:, rank:, :].any()


# ---------------------------------------------------------------------------
# (5) optimizers and schedules
# ---------------------------------------------------------------------------

def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((4, 3), dtype=np.float32),
            "sub": {"b": rng.standard_normal(5, dtype=np.float32)}}
    grads = [jax.tree.map(lambda p: rng.standard_normal(
        p.shape).astype(np.float32), tree) for _ in range(4)]
    return tree, grads


@pytest.mark.parametrize("make", [
    lambda o, s: o.adamw(1e-2),
    lambda o, s: o.adamw(s.cosine_decay(3e-2, 4, warmup_steps=2),
                         weight_decay=0.1),
    lambda o, s: o.sgd(s.linear_warmup(0.1, 3)),
    lambda o, s: o.sgd(0.05, momentum=0.9),
])
def test_optimizers_match_reference(make):
    tree, grads = _opt_trees(0)
    jo, to = make(j_opt, j_sched), make(t_opt, t_sched)
    jp, tp = jax.tree.map(jnp.asarray, tree), interop.tree_from_numpy(
        tree, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = to.update(interop.tree_from_numpy(g, "cpu"), ts, tp)
        jp, tp = j_opt.apply_updates(jp, ju), t_opt.apply_updates(tp, tu)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, b, rtol=1e-6, atol=1e-7), _np(jp), interop.tree_to_numpy(tp))
    assert int(ts["step"]) == int(js["step"]) == len(grads)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, grads = _opt_trees(1)
    jg, jn = j_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads[0]),
                                       max_norm)
    tg, tn = t_opt.clip_by_global_norm(
        interop.tree_from_numpy(grads[0], "cpu"), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6),
                 _np(jg), interop.tree_to_numpy(tg))


def test_schedules_match_reference():
    for jf, tf in ((j_sched.constant(3e-4), t_sched.constant(3e-4)),
                   (j_sched.linear_warmup(1e-3, 5),
                    t_sched.linear_warmup(1e-3, 5)),
                   (j_sched.cosine_decay(1e-3, 20, 4),
                    t_sched.cosine_decay(1e-3, 20, 4))):
        for step in (0, 1, 3, 5, 11, 20, 25):
            np.testing.assert_allclose(
                float(tf(torch.tensor(step, dtype=torch.int32))),
                float(jf(jnp.asarray(step, jnp.int32))), rtol=1e-6)


# ---------------------------------------------------------------------------
# (6), (7) the local and cohort trainers
# ---------------------------------------------------------------------------

def _assert_trained_close(got, want, init):
    """Leaf by leaf: element-wise within TRAINED, and the difference's norm
    small against the reference's change from the initial value."""
    def check(g, w, i):
        np.testing.assert_allclose(g, w, **TRAINED)
        change = np.linalg.norm(w - i)
        assert change > 0
        assert np.linalg.norm(g - w) <= 1e-3 * change
    jax.tree.map(check, got, want, init)


def _assert_masked_untouched(before, after, masks):
    for t, m in masks.items():
        dead = m[0] == 0
        np.testing.assert_array_equal(after["factors"][t]["A"][..., dead],
                                      before["factors"][t]["A"][..., dead])
        np.testing.assert_array_equal(after["factors"][t]["B"][..., dead, :],
                                      before["factors"][t]["B"][..., dead, :])


def test_local_train_matches_reference(setup):
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    steps, rank = 6, 4
    masks = _masks(jcfg, rank)
    data = client_batches(setup["tokens"], setup["labels"],
                          np.arange(96), steps, 8, seed=5)
    jlocal = j_client.make_local_train(jcfg, j_opt.adamw(LR))
    jtr, jloss = jlocal(setup["jfrozen"],
                        jax.tree.map(jnp.asarray, setup["trainable"]),
                        jax.tree.map(jnp.asarray, masks),
                        jax.tree.map(jnp.asarray, data))
    metrics = MetricsRegistry()
    # step times need the recorder's clock; the losses only the registry
    tlocal = make_local_train(tcfg, t_opt.adamw(LR), device="cpu",
                              metrics=metrics, recorder=Recorder())
    ttr, tloss = tlocal(setup["tfrozen"],
                        interop.tree_from_numpy(setup["trainable"], "cpu"),
                        interop.tree_from_numpy(masks, "cpu"), data)
    np.testing.assert_allclose(float(tloss), float(jloss), **FWD)
    # per-step losses: each equals the reference's loss at the reference's
    # own weights before that step (its scan run on a prefix of the data)
    per_step = metrics.histogram("train.loss").values()
    assert len(per_step) == steps and metrics.histogram(
        "train.step_s").count == steps
    assert np.mean(per_step) == pytest.approx(float(tloss), rel=1e-6)
    tr = jax.tree.map(jnp.asarray, setup["trainable"])
    for i in range(steps):
        want = j_model.loss_fn(_jparams(setup, tr, masks),
                               {k: v[i] for k, v in data.items()}, jcfg,
                               remat=False)[0]
        np.testing.assert_allclose(per_step[i], float(want), **FWD)
        if i + 1 < steps:
            tr = jlocal(setup["jfrozen"],
                        jax.tree.map(jnp.asarray, setup["trainable"]),
                        jax.tree.map(jnp.asarray, masks),
                        {k: jnp.asarray(v[:i + 1])
                         for k, v in data.items()})[0]
    ttr, jtr = interop.tree_to_numpy(ttr), _np(jtr)
    _assert_trained_close(ttr, jtr, setup["trainable"])
    _assert_masked_untouched(setup["trainable"], ttr, masks)


def test_cohort_train_matches_reference_vmap(setup):
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    ranks, steps = (2, 4, 8), 3
    per = [_masks(jcfg, r) for r in ranks]
    masks = {t: np.stack([m[t] for m in per]) for t in jcfg.lora.targets}
    trainable = jax.tree.map(lambda a: np.stack([a] * len(ranks)),
                             setup["trainable"])
    data = {k: np.stack([client_batches(
        setup["tokens"], setup["labels"], np.arange(96), steps, 8,
        seed=10 + c)[k] for c in range(len(ranks))])
        for k in ("tokens", "labels")}
    jtr, jloss = j_client.make_cohort_train(jcfg, j_opt.adamw(LR))(
        setup["jfrozen"], jax.tree.map(jnp.asarray, trainable),
        jax.tree.map(jnp.asarray, masks), jax.tree.map(jnp.asarray, data))
    ttr, tloss = make_cohort_train(tcfg, t_opt.adamw(LR), device="cpu")(
        setup["tfrozen"], interop.tree_from_numpy(trainable, "cpu"),
        interop.tree_from_numpy(masks, "cpu"),
        {k: _t(v) for k, v in data.items()})
    assert tloss.shape == (len(ranks),)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **FWD)
    ttr, jtr = interop.tree_to_numpy(ttr), _np(jtr)
    _assert_trained_close(ttr, jtr, trainable)
    for c, m in enumerate(per):
        _assert_masked_untouched(
            jax.tree.map(lambda a: a[c], trainable),
            jax.tree.map(lambda a: a[c], ttr), m)


def test_trainer_refuses_a_base_on_another_device(setup):
    local = make_local_train(setup["tcfg"], t_opt.adamw(LR), device="meta")
    with pytest.raises(ValueError, match="frozen base"):
        local(setup["tfrozen"], {}, {}, {})


# ---------------------------------------------------------------------------
# (8) data: bit-identical to the reference's generators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["qqp", "mrpc", "rte"])
def test_pair_classification_data_identical(task):
    for seed, vocab in ((0, 50265), (7, 100)):
        got = make_pair_classification(task, 300, seed=seed,
                                       vocab_size=vocab)
        want = j_pairs(task, 300, seed=seed, vocab_size=vocab)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_partition_batches_and_stacked_client_data_identical():
    _, labels = j_pairs("mrpc", 512, seed=1)
    tokens = np.arange(512 * 4, dtype=np.int32).reshape(512, 4)
    for num_clients, alpha, seed in ((4, 0.5, 0), (10, 0.1, 3)):
        got = dirichlet_partition(labels, num_clients, alpha, seed=seed)
        want = j_dirichlet(labels, num_clients, alpha, seed=seed)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    shards = want
    got = client_batches(tokens, labels, shards[2], 5, 7, seed=9)
    want = j_client_batches(tokens, labels, shards[2], 5, 7, seed=9)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])
    sim, jsim = SimConfig(local_steps=3, local_batch=5, seed=2), \
        JSimConfig(local_steps=3, local_batch=5, seed=2)
    got = stack_client_data(tokens, labels, shards, [1, 7, 4], sim, rnd=3)
    want = j_stack(tokens, labels, shards, [1, 7, 4], jsim, rnd=3)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert dataclasses.asdict(SimConfig()) == dataclasses.asdict(JSimConfig())
