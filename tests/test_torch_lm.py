"""Next-token LM training in the port against the reference's, on the CPU.

Both sides start from the reference's own weights
(``repro.models.model.init_params`` on ``gemma-reduced``: 2 layers,
d_model 128, MQA, GeGLU, tied embeddings; and ``minitron-reduced``: GQA
with 2 KV heads, SiLU, an untied ``lm_head``), carried over by
``repro_torch.interop``; the data comes from numpy.

Tolerances, float32 throughout:
- ``make_bigram_lm``: bit for bit;
- attention: rtol 1e-5, atol 1e-5 (the same float32 products summed in
  another order, values O(1)), as in ``tests/test_torch_model.py``;
- the loss and its metrics: rtol 1e-5; every leaf's gradient normwise,
  ||port - ref|| <= ``GRAD_REL`` (1e-5) of ||ref|| (the same reordering
  through two layers), and exact zeros equal on both sides;
- ``remat`` and ``q_chunk`` within the port: the same bits for ``remat``
  (the same operations run again) and ``GRAD_REL`` for ``q_chunk``;
- training against the reference example's loop: each loss within
  ``LOSS_ATOL`` (1e-5, values ~5.5) and every trained leaf normwise within
  ``CHANGE_REL`` (1e-3) of the change the steps made, as in
  ``tests/test_torch_pretrain.py`` (Adam's first steps move an element by
  about lr · sign(g), so an element whose gradient is within rounding of
  zero may move the other way on one side).
"""
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as j_store
from repro.configs import get_reduced as j_get_reduced
from repro.data import make_bigram_lm as j_bigram
from repro.models import common as j_common
from repro.models import model as j_model
from repro_torch import interop
from repro_torch.configs import get_reduced
from repro_torch.data import bigram_nll, make_bigram_lm
from repro_torch.fed import simulation as t_sim
from repro_torch.models import common as t_common
from repro_torch.models import model as t_model

ROOT = Path(__file__).resolve().parents[1]
DENSE_ARCHS = ("gemma-2b", "minitron-4b")   # tied head, MQA; lm_head, GQA
# top-2 of 4 experts; top-1 of 4 with the shared expert
ARCHS = DENSE_ARCHS + ("olmoe-1b-7b", "llama4-maverick-400b-a17b")
GRAD_REL = 1e-5
LOSS_ATOL = 1e-5
CHANGE_REL = 1e-3
SEQ = 12


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


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _paths(tree[k], prefix + (k,)).items()}
    return {prefix: tree}


def _flat_np(tree):
    return {p: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for p, v in _paths(tree).items()}


def _example(name: str, file: str):
    """An example script as a module (``examples/`` is not a package)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples"
                                                  / file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def lm_example():
    return _example("lm_pretrain_torch", "lm_pretrain_torch.py")


def _arch(name):
    """The reference's seed-0 weights with live adapters (small random B,
    a trained-looking mask), so that A's and the mask's gradients carry
    signal (at B = 0 they are exactly 0)."""
    jcfg, tcfg = j_get_reduced(name), get_reduced(name)
    tree = jax.tree.map(np.array, j_model.init_params(jax.random.PRNGKey(0),
                                                      jcfg))
    rng = np.random.default_rng(3)
    for ad in tree["lora"].values():
        ad["B"] = (0.05 * rng.standard_normal(ad["B"].shape)).astype(
            np.float32)
        ad["mask"] = (ad["mask"] * rng.uniform(0.8, 1.2, ad["mask"].shape)
                      ).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, tree=tree)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return _arch(request.param)


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def dense_arch(request):
    return _arch(request.param)


# ---------------------------------------------------------------------------
# (1) the data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,seq,vocab,seed,temp", [
    (4, 8, 16, 0, 1.0), (33, 17, 256, 3, 1.0), (64, 64, 256, 0, 0.5),
    (7, 5, 1000, 11, 2.0)])
def test_make_bigram_lm_bit_identical(n, seq, vocab, seed, temp):
    want = j_bigram(n, seq, vocab, seed=seed, temp=temp)
    got = make_bigram_lm(n, seq, vocab, seed=seed, temp=temp)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == (n, seq)
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_bigram_nll_is_the_chain_entropy_of_the_data():
    """The chain's NLL against the chain's probabilities rebuilt the
    reference's way (``make_bigram_lm``'s own draw), and below ln V."""
    vocab, seed, temp = 64, 5, 0.7
    data = make_bigram_lm(200, 16, vocab, seed=seed, temp=temp)
    logits = np.random.default_rng(seed).normal(size=(vocab, vocab)) / temp
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    want = -np.log(probs[data["tokens"], data["labels"]]).mean()
    got = bigram_nll(data, vocab, seed=seed, temp=temp)
    assert got == pytest.approx(want, rel=1e-12)
    assert 0 < got < np.log(vocab)


# ---------------------------------------------------------------------------
# (2) attention in query chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_chunk", [16, 12, 4, 5, 1],
                         ids=["above-sq", "sq", "divisor", "non-divisor",
                              "one"])
@pytest.mark.parametrize("causal,window,hkv,q_offset", [
    (True, None, 1, 0), (True, 5, 2, 0), (False, None, 4, 0),
    (True, None, 2, 7), (True, 3, 1, 4)],
    ids=["causal-mqa", "window-gqa", "full-mha", "offset-gqa",
         "window-offset-mqa"])
def test_chunked_attention_matches_reference(q_chunk, causal, window, hkv,
                                             q_offset):
    """Sq 12 against q_chunk >= Sq, Sq itself, a divisor, a non-divisor
    (5: chunks of 4, the largest divisor that fits) and 1."""
    rng = np.random.default_rng(q_chunk + 10 * hkv)
    skv = SEQ + q_offset
    q = rng.standard_normal((2, SEQ, 4, 8), dtype=np.float32)
    k = rng.standard_normal((2, skv, hkv, 8), dtype=np.float32)
    v = rng.standard_normal((2, skv, hkv, 8), dtype=np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = t_common.attention(_t(q), _t(k), _t(v), q_chunk=q_chunk, **kw)
    want = j_common.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_chunk=q_chunk, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    whole = t_common.attention(_t(q), _t(k), _t(v), q_chunk=SEQ, **kw)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# (3) the LM loss and every leaf's gradient
# ---------------------------------------------------------------------------

def _lm_batch(cfg, masked: str, rows: int = 3):
    data = make_bigram_lm(rows, SEQ, cfg.vocab_size, seed=9)
    labels = data["labels"].copy()
    if masked == "some":        # padding at the ends, one row half empty
        labels[:, -2:] = -1
        labels[1, SEQ // 2:] = -100
    elif masked == "all":
        labels[:] = -1
    return {"tokens": data["tokens"], "labels": labels}


# one compile per (config, remat, q_chunk), shared by the masking cases
_J_VALUE_AND_GRAD = jax.jit(
    jax.value_and_grad(j_model.loss_fn, has_aux=True),
    static_argnames=("cfg", "remat", "q_chunk"))


def _reference_loss_and_grads(jcfg, tree, batch, remat, q_chunk):
    (total, metrics), grads = _J_VALUE_AND_GRAD(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch),
        cfg=jcfg, remat=remat, q_chunk=q_chunk)
    return total, metrics, grads


def _hold_grads(got, want):
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert np.isfinite(g).all(), path
        err = np.linalg.norm((g - w).astype(np.float64))
        assert err <= GRAD_REL * np.linalg.norm(w.astype(np.float64)), (
            "/".join(path), err)
        assert np.array_equal(g == 0, w == 0), path


@pytest.mark.parametrize("remat,q_chunk", [(False, 1024), (True, 1024),
                                           (True, 5)],
                         ids=["plain", "remat", "remat-chunk5"])
@pytest.mark.parametrize("masked", ["none", "some"])
def test_lm_loss_and_every_gradient_match_jax(arch, remat, q_chunk, masked):
    """``loss_fn``'s LM branch and the gradient of every leaf (the LoRA
    masks and the head included; a MoE decoder's router and experts, the
    aux term included) against ``jax.value_and_grad``, with ``remat`` on
    and off and queries in chunks below S (5 takes chunks of 4 of the 12
    positions), labels < 0 left out."""
    jcfg, tcfg, tree = arch["jcfg"], arch["tcfg"], arch["tree"]
    batch = _lm_batch(tcfg, masked)
    total_j, m_j, grads_j = _reference_loss_and_grads(jcfg, tree, batch,
                                                      remat, q_chunk)
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    tb = {k: _t(v) for k, v in batch.items()}
    loss_t, grads_t = t_sim.pretrain_loss_and_grads(
        params.tree(), tb, tcfg, remat=remat, q_chunk=q_chunk)
    with torch.no_grad():
        total_t, m_t = t_model.loss_fn(params, tb, tcfg, remat=remat,
                                       q_chunk=q_chunk)
    assert sorted(m_t) == sorted(m_j) == ["aux", "loss", "nll"]
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5,
                                   err_msg=k)
    # the dense families' aux is 0; a MoE decoder's the load balance loss
    assert (float(m_t["aux"]) > 0.0) == bool(tcfg.num_experts)
    assert float(total_t) == float(loss_t)
    np.testing.assert_allclose(float(loss_t), float(total_j), rtol=1e-5)
    _hold_grads(_flat_np(grads_t), _flat_np(grads_j))
    if "lm_head" in params.tree():
        # untied: the embedding's gradient comes from the gather alone
        unused = np.setdiff1d(np.arange(tcfg.vocab_size), batch["tokens"])
        assert unused.size
        assert not _flat_np(grads_t)[("embed",)][unused].any()


def test_all_masked_batch_gives_zero_loss_and_gradients(dense_arch):
    jcfg, tcfg, tree = (dense_arch["jcfg"], dense_arch["tcfg"],
                        dense_arch["tree"])
    batch = _lm_batch(tcfg, "all")
    total_j, m_j, grads_j = _reference_loss_and_grads(jcfg, tree, batch,
                                                      True, 1024)
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    loss_t, grads_t = t_sim.pretrain_loss_and_grads(
        params.tree(), {k: _t(v) for k, v in batch.items()}, tcfg,
        remat=True)
    assert float(loss_t) == float(total_j) == 0.0
    got, want = _flat_np(grads_t), _flat_np(grads_j)
    _hold_grads(got, want)
    assert not any(g.any() for g in got.values())


@pytest.mark.parametrize("q_chunk", [1024, 4])
def test_remat_gives_the_same_bits(arch, q_chunk):
    """Per-layer recomputation runs the same operations on the same inputs
    again: the loss and every gradient bit for bit; and query chunks
    change no value past float32 reordering."""
    tcfg, tree = arch["tcfg"], arch["tree"]
    params = interop.params_from_jax(tree, tcfg, device="cpu")
    tb = {k: _t(v) for k, v in _lm_batch(tcfg, "some").items()}
    runs = {remat: t_sim.pretrain_loss_and_grads(params.tree(), tb, tcfg,
                                                 remat=remat,
                                                 q_chunk=q_chunk)
            for remat in (False, True)}
    assert float(runs[True][0]) == float(runs[False][0])
    on, off = _flat_np(runs[True][1]), _flat_np(runs[False][1])
    for path in off:
        assert np.array_equal(on[path], off[path]), path
    if q_chunk < SEQ:
        _, whole = t_sim.pretrain_loss_and_grads(params.tree(), tb, tcfg,
                                                 remat=False)
        _hold_grads(off, _flat_np(whole))


def test_classifier_loss_takes_remat_and_q_chunk():
    """The classification branch with the new options: the same loss and
    accuracy either way, as the reference's."""
    tcfg = get_reduced("roberta-large")
    params = t_model.init_params(tcfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": _t(rng.integers(3, 256, (4, 10)).astype(np.int32)),
             "labels": _t(np.array([0, 1, 1, 0], np.int32))}
    base, m0 = t_model.loss_fn(params, batch, tcfg, remat=False)
    for kw in (dict(remat=True), dict(remat=False, q_chunk=3)):
        loss, m = t_model.loss_fn(params, batch, tcfg, **kw)
        assert sorted(m) == ["acc", "loss"]
        np.testing.assert_allclose(float(loss), float(base), rtol=1e-6)
        assert float(m["acc"]) == float(m0["acc"])


# ---------------------------------------------------------------------------
# (4) the example's loop against the reference example's, and its main
# ---------------------------------------------------------------------------

def _hold_train_against_reference_example(monkeypatch, tmp_path, lm_example,
                                          name, noise=()):
    """5 steps of ``examples/lm_pretrain.py``'s own ``main`` (``--arch``
    ``name``'s reduced config, batch 16 x 64, lr 3e-3, ``remat`` with
    q_chunk 64; its losses logged through ``jax.debug.callback`` inside the
    jitted step, its weights read from its checkpoint) against the port's
    ``train`` from the same seed-0 weights and data. The leaves named in
    ``noise`` (paths) have a gradient that is zero in exact arithmetic
    (a key bias under the softmax) and rounding noise on either side,
    which AdamW turns into steps in no particular direction: their change
    is not compared, and each side's is held to at most lr an element a
    step (AdamW's normalised step, which the warmup only shrinks)."""
    steps, lr = 5, 3e-3
    logged, loss_fn = [], j_model.loss_fn

    def logging_loss(*args, **kw):
        out = loss_fn(*args, **kw)
        jax.debug.callback(lambda v: logged.append(float(v)), out[0])
        return out

    monkeypatch.setattr(j_model, "loss_fn", logging_loss)
    ref_dir = tmp_path / "ref"
    monkeypatch.setattr(sys, "argv", ["lm_pretrain.py", "--arch", name,
                                      "--steps", str(steps), "--ckpt-dir",
                                      str(ref_dir)])
    _example("lm_pretrain_ref", "lm_pretrain.py").main()
    monkeypatch.setattr(j_model, "loss_fn", loss_fn)
    ref_tree, ref_meta = j_store.restore(str(ref_dir))
    assert len(logged) == steps and ref_meta["step"] == steps

    jcfg, tcfg = j_get_reduced(name), get_reduced(name)
    init = jax.tree.map(np.array, j_model.init_params(jax.random.PRNGKey(0),
                                                      jcfg))
    params = interop.params_from_jax(init, tcfg, device="cpu")
    data = make_bigram_lm(4096, 64, tcfg.vocab_size, seed=0)
    trained, losses = lm_example.train(
        tcfg, params, data, steps=steps, batch=16, lr=lr, remat=True,
        q_chunk=64, device="cpu")
    np.testing.assert_allclose(losses, logged, rtol=0, atol=LOSS_ATOL)
    assert ref_meta["loss"] == pytest.approx(losses[-1], abs=LOSS_ATOL)
    got, before = _flat_np(trained.tree()), _flat_np(init)
    want = {p: np.asarray(v) for p, v in _paths(ref_tree).items()}
    assert sorted(got) == sorted(want) == sorted(before)
    for path, w in want.items():
        if path in noise:
            for side in (w, got[path]):
                assert np.abs(side - before[path]).max() <= steps * lr, path
            continue
        change = np.linalg.norm((w - before[path]).astype(np.float64))
        assert change > 0, path
        err = np.linalg.norm((got[path] - w).astype(np.float64))
        assert err <= CHANGE_REL * change, ("/".join(path), err, change)


def test_train_matches_the_reference_example_loop(monkeypatch, tmp_path,
                                                  lm_example):
    """The reference example's default, gemma-reduced."""
    _hold_train_against_reference_example(monkeypatch, tmp_path, lm_example,
                                          "gemma-2b")


def test_train_matches_the_reference_example_loop_on_moe(
        monkeypatch, tmp_path, lm_example):
    """``--arch olmoe-1b-7b`` (olmoe-reduced: 2 layers, top-2 of 4
    experts; 16 x 64 tokens, one group of 1024, capacity 1.25): the loss
    with its aux term, the router and every expert trained."""
    _hold_train_against_reference_example(monkeypatch, tmp_path, lm_example,
                                          "olmoe-1b-7b")


def test_example_main_runs_a_moe_arch_on_the_cpu(lm_example):
    """``main(["--arch", "olmoe-1b-7b", "--device", "cpu", ...])`` and the
    Llama-4 alias take their reduced configs and give ``train``'s losses
    from the port's own seed-0 weights."""
    for name in ("olmoe-1b-7b", "llama4-maverick-400b-a17b"):
        losses = lm_example.main(["--arch", name, "--steps", "3", "--batch",
                                  "4", "--seq", "16", "--device", "cpu"])
        tcfg = get_reduced(name)
        assert tcfg.arch_type == "moe"
        _, again = lm_example.train(
            tcfg, t_model.init_params(tcfg, seed=0, device="cpu"),
            make_bigram_lm(4096, 16, tcfg.vocab_size, seed=0), steps=3,
            batch=4, lr=3e-3, remat=True, q_chunk=64, device="cpu")
        assert len(losses) == 3 and np.isfinite(losses).all()
        assert again == losses


def test_example_main_on_the_cpu_saves_a_checkpoint_the_reference_reads(
        tmp_path, capsys, lm_example):
    """``main([... "--device", "cpu"])`` at gemma-reduced: finite losses
    printed at the reference's steps, and a checkpoint that the
    reference's store reads back equal to ``train``'s own result."""
    argv = ["--steps", "21", "--batch", "4", "--seq", "16", "--ckpt-dir",
            str(tmp_path), "--device", "cpu"]
    losses = lm_example.main(argv)
    out = capsys.readouterr().out
    assert len(losses) == 21 and np.isfinite(losses).all()
    assert [int(s) for s in
            re.findall(r"step +(\d+): loss=", out)] == [0, 20]
    assert f"checkpoint saved: {tmp_path}" in out

    tcfg = get_reduced("gemma-2b")
    trained, again = lm_example.train(
        tcfg, t_model.init_params(tcfg, seed=0, device="cpu"),
        make_bigram_lm(4096, 16, tcfg.vocab_size, seed=0), steps=21,
        batch=4, lr=3e-3, remat=True, q_chunk=64, device="cpu")
    assert again == losses
    tree, meta = j_store.restore(str(tmp_path))
    assert meta == {"step": 21, "arch": "gemma-reduced", "loss": losses[-1]}
    got = {p: np.asarray(v) for p, v in _paths(tree).items()}
    want = _flat_np(trained.tree())
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype and np.array_equal(got[path], w), \
            path


def test_example_refuses_an_encoder(lm_example):
    with pytest.raises(SystemExit, match="decoder"):
        lm_example.main(["--arch", "roberta-large", "--device", "cpu"])
