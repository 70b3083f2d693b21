"""The MoE load-balance term over a 30-step LM run, the port against the
reference, on the CPU.

On the card, OLMoE-1B-7B's LM example at 4 layers sees its aux term climb
from ~4.5 to 14-16 over 30 steps. Whether the reference does the same was
unseen: the LM loops were held to each other only at olmoe-reduced (2
layers, top-2 of 4) over 5 steps (``tests/test_torch_lm.py``). Here both
packages run the reference example's loop (AdamW under
``cosine_decay(3e-3, 30, warmup_steps=20)``, ``remat`` with q_chunk 64, 16
x 64 bigram tokens a step, batches picked by ``default_rng(0)``) on an
OLMoE-shaped config between reduced and full: 4 layers, 16 experts, top-4,
d_model 128, from the reference's seed-0 weights through ``interop``.

Tolerances, float32 throughout:
- aux, step by step: within ``AUX_REL`` (1e-3) of the reference's. The
  two agree to ~2e-7 (rounding) until a token's k-th and (k+1)-th router
  probabilities tie within rounding and the sides pick different experts
  (step 23 here); from there the runs drift apart by up to 2.3e-4
  (measured), a chaotic divergence of training, not a fault;
- the loss, step by step: within ``LOSS_ATOL`` (1e-3; measured up to
  1.8e-4 after the flip, 2e-6 before);
- the climb: on both sides aux rises by more than ``CLIMB`` (40%) from
  its first value to its largest (4.23 -> 6.32 measured), so the climb
  is the reference's own behaviour.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.data import make_bigram_lm as j_bigram
from repro.models import model as j_model
from repro.optim import adamw as j_adamw
from repro.optim import apply_updates as j_apply
from repro.optim import cosine_decay as j_cosine
from repro_torch import interop
from repro_torch.configs import get_reduced
from repro_torch.data import make_bigram_lm
from repro_torch.models import model as t_model

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(num_layers=4, num_experts=16, experts_per_token=4)
STEPS, BATCH, SEQ, LR = 30, 16, 64, 3e-3
AUX_REL = 1e-3
LOSS_ATOL = 1e-3
CLIMB = 0.4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: no contention with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_run(jcfg, params):
    """The reference example's loop (``examples/lm_pretrain.py``), its
    step returning the aux term beside the loss."""
    data = j_bigram(4096, SEQ, jcfg.vocab_size, seed=0)
    opt = j_adamw(j_cosine(LR, STEPS, warmup_steps=20))
    state = opt.init(params)

    @jax.jit
    def step(params, state, batch):
        def loss(p):
            total, metrics = j_model.loss_fn(p, batch, jcfg, remat=True,
                                             q_chunk=64)
            return total, metrics["aux"]
        (total, aux), g = jax.value_and_grad(loss, has_aux=True)(params)
        upd, state = opt.update(g, state, params)
        return j_apply(params, upd), state, total, aux

    rng = np.random.default_rng(0)
    losses, auxes = [], []
    for _ in range(STEPS):
        picks = rng.integers(0, len(data["tokens"]), size=BATCH)
        batch = {k: jnp.asarray(data[k][picks]) for k in ("tokens", "labels")}
        params, state, total, aux = step(params, state, batch)
        losses.append(float(total))
        auxes.append(float(aux))
    return np.asarray(losses), np.asarray(auxes)


def test_moe_aux_term_climbs_alike_in_both_lm_loops(monkeypatch):
    jcfg = j_get_reduced("olmoe-1b-7b").with_(**SHAPE)
    tcfg = get_reduced("olmoe-1b-7b").with_(**SHAPE)
    params = j_model.init_params(jax.random.PRNGKey(0), jcfg)
    init = jax.tree.map(np.array, params)
    want_loss, want_aux = _reference_run(jcfg, params)

    spec = importlib.util.spec_from_file_location(
        "lm_pretrain_torch", ROOT / "examples" / "lm_pretrain_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    auxes, loss_fn = [], t_model.loss_fn

    def logging_loss(*args, **kw):
        out = loss_fn(*args, **kw)
        auxes.append(float(out[1]["aux"].detach()))
        return out

    monkeypatch.setattr(t_model, "loss_fn", logging_loss)
    _, losses = example.train(
        tcfg, interop.params_from_jax(init, tcfg, device="cpu"),
        make_bigram_lm(4096, SEQ, tcfg.vocab_size, seed=0), steps=STEPS,
        batch=BATCH, lr=LR, remat=True, q_chunk=64, device="cpu")
    got_aux = np.asarray(auxes)
    assert got_aux.shape == want_aux.shape == (STEPS,)
    rel = np.abs(got_aux - want_aux) / want_aux
    print("aux, reference:", np.round(want_aux, 4).tolist())
    print("aux relative difference by step:", rel.tolist())
    assert rel.max() <= AUX_REL, (int(rel.argmax()), float(rel.max()))
    np.testing.assert_allclose(losses, want_loss, rtol=0, atol=LOSS_ATOL)
    for side in (want_aux, got_aux):
        assert side.max() > (1 + CLIMB) * side[0], side.tolist()
