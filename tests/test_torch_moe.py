"""The port's mixture-of-experts FFN against the reference's, on the CPU.

``repro_torch.models.moe.moe_ffn`` dispatches by a permutation (each kept
(token, slot) row to its own (expert, position) row) where
``repro.models.moe.moe_ffn`` contracts a one-hot dispatch tensor; a
one-hot contraction picks exactly one term, so the two must give the same
numbers. Inputs come from numpy and the weights are the reference's own
(``init_moe_params``), for OLMoE's and Llama-4's reduced configs (Llama-4
adds the always-on shared expert), at the config's group size and at 8,
and at capacity factors that drop slots and that drop none.

Tolerances, float32 throughout:
- y: rtol 1e-5, atol 1e-6 (the experts' products summed in another
  order; values O(1));
- aux: 1e-6 relative;
- routing indices and keep masks: exactly equal. The smallest gap between
  a token's k-th and (k+1)-th router probability is asserted above
  ``MIN_GAP``, so that a near-tie, where the two sides' rounding may pick
  different experts, fails loudly instead of hiding;
- gradients against ``jax.vjp``: rtol 1e-4, atol 1e-5 of the leaf's
  largest entry (``tests/test_torch_train.py``'s);
- the local trainer against the reference's after 3 steps:
  ``tests/test_torch_train.py``'s forward and trained-factor tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.fed import client as j_client
from repro.models import model as j_model
from repro.models import moe as j_moe
from repro.optim import optimizers as j_opt
from repro_torch import interop
from repro_torch.configs import get_reduced
from repro_torch.data import make_bigram_lm
from repro_torch.fed import make_local_train, split_adapters, split_head
from repro_torch.models import model as t_model
from repro_torch.models import moe as t_moe
from repro_torch.optim import optimizers as t_opt

ARCHS = ("olmoe-1b-7b", "llama4-maverick-400b-a17b")
CAPACITY_FACTORS = (1.25, 1.0, 0.5, 8.0)
MIN_GAP = 1e-5
Y_TOL = dict(rtol=1e-5, atol=1e-6)
AUX_REL = 1e-6
FWD = dict(rtol=1e-4, atol=1e-5)
LR = 1e-3
TRAINED = dict(rtol=1e-4, atol=0.05 * LR)
B, S = 2, 16


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


def _configs(name, group=None, cf=None):
    jcfg, tcfg = j_get_reduced(name), get_reduced(name)
    kw = {}
    if group is not None:
        kw["moe_group_size"] = group
    if cf is not None:
        kw["moe_capacity_factor"] = cf
    return jcfg.with_(**kw), tcfg.with_(**kw)


def _weights(jcfg, seed=0):
    """One layer of the reference's own MoE weights, as numpy."""
    p = j_moe.init_moe_params(jax.random.PRNGKey(seed), jcfg, 1, jnp.float32)
    return {k: np.asarray(v[0]) for k, v in p.items()}


def _x(cfg, seed=0, b=B, s=S):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _reference_routing(x, router, cfg):
    """The reference's routing (``repro/models/moe.py:38-58``): top-k
    indices (G, g, k) and keep mask (G, g·k), and each token's gap between
    its k-th and (k+1)-th probability."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    g = min(cfg.moe_group_size, b * s)
    cap = t_moe.capacity(cfg, g)
    xg = jnp.asarray(x).reshape(-1, g, d)
    probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", xg, jnp.asarray(router)),
                           axis=-1)
    _, top_idx = jax.lax.top_k(probs, k)
    ohf = jax.nn.one_hot(top_idx, e).reshape(xg.shape[0], g * k, e)
    pos = jnp.sum((jnp.cumsum(ohf, axis=1) - ohf) * ohf, axis=-1)
    keep = (pos < cap) & (jnp.sum(ohf, axis=-1) > 0)
    srt = -np.sort(-np.asarray(probs), axis=-1)
    gap = srt[..., k - 1] - srt[..., k] if k < e else srt[..., k - 1]
    return np.asarray(top_idx), np.asarray(keep), gap


def _shared_adapters(cfg, seed):
    """Live adapters on the shared expert's w1, w3 and w2 (half rank)."""
    rng = np.random.default_rng(seed)
    r = cfg.lora.r_max
    mask = (np.arange(r) < r // 2).astype(np.float32)
    shapes = {"w1": (cfg.d_model, cfg.d_ff), "w3": (cfg.d_model, cfg.d_ff),
              "w2": (cfg.d_ff, cfg.d_model)}
    return {t: {"A": (rng.standard_normal((i, r)) / np.sqrt(i)).astype(
                    np.float32),
                "B": (0.05 * rng.standard_normal((r, o))).astype(np.float32),
                "mask": mask}
            for t, (i, o) in shapes.items()}


# ---------------------------------------------------------------------------
# forward: y, aux and routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("group", [None, 8], ids=["config-group", "group8"])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_ffn_matches_reference(name, group, cf):
    """y, aux and the routing of ``moe_ffn`` against the reference's, at
    the config's group size (one group of 32 tokens) and at 8 (four
    groups), with capacity 1.25, 1.0, 0.5 (slots dropped) and 8.0 (none)."""
    jcfg, tcfg = _configs(name, group, cf)
    p, x = _weights(jcfg), _x(jcfg)
    yj, aj = j_moe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg)
    yt, at = t_moe.moe_ffn(_t(x), {k: _t(v) for k, v in p.items()}, tcfg)
    assert at.dtype == torch.float32 and at.shape == ()
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **Y_TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=AUX_REL)

    top_idx, keep, gap = _reference_routing(x, p["router"], jcfg)
    assert gap.min() > MIN_GAP, f"near-tie in the router: {gap.min()}"
    g = t_moe.group_size(tcfg, B * S)
    r = t_moe.route(_t(x).reshape(-1, g, tcfg.d_model), _t(p["router"]),
                    tcfg)
    np.testing.assert_array_equal(r.top_idx.numpy(), top_idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if cf == 0.5:      # fewer slots than the tokens ask for: some dropped
        assert not keep.all()
    if cf == 8.0:
        assert keep.all()
    # a dropped slot's gate is 0; the token's other gates keep their value
    gates = r.gates.numpy()
    assert (gates[~keep] == 0).all() and (gates[keep] > 0).all()


def test_shared_expert_takes_its_adapters():
    """Llama-4's shared expert through ``apply_lora`` with live adapters on
    w1, w3 and w2, against the reference's."""
    jcfg, tcfg = _configs("llama4-maverick-400b-a17b")
    p, x = _weights(jcfg, seed=1), _x(jcfg, seed=1)
    ad = _shared_adapters(jcfg, 2)
    yj, aj = j_moe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg,
                           jax.tree.map(jnp.asarray, ad))
    yt, at = t_moe.moe_ffn(_t(x), {k: _t(v) for k, v in p.items()}, tcfg,
                           interop.tree_from_numpy(ad, "cpu"))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **Y_TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=AUX_REL)
    plain, _ = t_moe.moe_ffn(_t(x), {k: _t(v) for k, v in p.items()}, tcfg)
    assert (plain - yt).abs().max() > 1e-3        # the adapters act


def test_zero_router_ties_go_to_the_lower_expert():
    """A zero router makes every probability 1/E: every token ties across
    all experts, and ``jax.lax.top_k`` takes the lowest k indices. The
    port's stable sort must take the same, so every token goes to experts
    0..k-1 and the capacity drops the rest."""
    for name in ARCHS:
        jcfg, tcfg = _configs(name)
        p, x = _weights(jcfg), _x(jcfg)
        p["router"] = np.zeros_like(p["router"])
        yj, aj = j_moe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                               jcfg)
        yt, at = t_moe.moe_ffn(_t(x), {k: _t(v) for k, v in p.items()}, tcfg)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **Y_TOL)
        np.testing.assert_allclose(float(at), float(aj), rtol=AUX_REL)
        top_idx, keep, _ = _reference_routing(x, p["router"], jcfg)
        r = t_moe.route(_t(x).reshape(1, B * S, -1), _t(p["router"]), tcfg)
        k = tcfg.experts_per_token
        assert (top_idx == np.arange(k)).all()
        np.testing.assert_array_equal(r.top_idx.numpy(), top_idx)
        np.testing.assert_array_equal(r.keep.numpy(), keep)
        assert int(keep.sum()) == k * r.capacity


def test_group_size_must_divide_the_tokens():
    """12 tokens in groups of 8: the port raises ``ValueError`` (the
    reference asserts) rather than picking another group size."""
    jcfg, tcfg = _configs("olmoe-1b-7b", group=8)
    p, x = _weights(jcfg), _x(jcfg, b=2, s=6)
    with pytest.raises(ValueError, match="not divisible by group size 8"):
        t_moe.moe_ffn(_t(x), {k: _t(v) for k, v in p.items()}, tcfg)
    with pytest.raises(AssertionError):
        j_moe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg)
    with pytest.raises(ValueError):
        t_moe.group_size(tcfg, 12)
    assert t_moe.group_size(tcfg, 4) == 4         # min(g, tokens) divides


def test_two_calls_give_the_same_bits():
    """Forward and backward twice: the same bits (no colliding adds)."""
    jcfg, tcfg = _configs("olmoe-1b-7b", cf=1.0)
    p, x = _weights(jcfg), _x(jcfg)

    def run():
        leaves = {k: _t(v).requires_grad_(True) for k, v in p.items()}
        xt = _t(x).requires_grad_(True)
        y, aux = t_moe.moe_ffn(xt, leaves, tcfg)
        grads = torch.autograd.grad(y.square().sum() + aux,
                                    [xt, *leaves.values()])
        return [y, aux, *grads]

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# backward against jax.vjp
# ---------------------------------------------------------------------------

def _grad_close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max(), err_msg=what)


def _vjps(jcfg, tcfg, p, x, dy, daux):
    """The cotangent (dy, daux) through the reference's ``moe_ffn``
    (``jax.vjp``) and the port's (autograd): ({leaf: grad}, {leaf: grad})
    over x and every weight."""
    (_, _), vjp = jax.vjp(lambda xx, pp: j_moe.moe_ffn(xx, pp, jcfg),
                          jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    gx_j, gp_j = vjp((jnp.asarray(dy), jnp.asarray(daux)))
    xt = _t(x).requires_grad_(True)
    leaves = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    yt, at = t_moe.moe_ffn(xt, leaves, tcfg)
    names = sorted(leaves)
    grads = torch.autograd.grad((yt * _t(dy)).sum() + at * float(daux),
                                [xt] + [leaves[n] for n in names])
    want = {"x": np.asarray(gx_j), **{n: np.asarray(gp_j[n]) for n in names}}
    got = {"x": grads[0].numpy(), **{n: g.numpy()
                                     for n, g in zip(names, grads[1:])}}
    return got, want


# Top-1 routing (Llama-4) renormalises a single probability: its gate is
# p / p = 1, whose gradient is exactly 0. What each side computes there,
# g / p - (g p) / p^2, is rounding noise of ~eps |g| / p a token, which
# reaches the router's gradient as ~1e-6 (5.9e-5 of its largest entry,
# measured on both sides) and differs between the two. There the router is
# held to the reference with the aux term alone (dy = 0, no noise), and on
# each side the whole gradient within NOISE_REL of its largest entry of
# that aux-only gradient.
NOISE_REL = 1e-3


@pytest.mark.parametrize("cf", [1.25, 0.5, 8.0])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_gradients_match_jax_vjp(name, cf):
    """d(y · dy + aux · daux) with respect to x, the router, we1, we3, we2
    and (Llama-4) the shared expert's w1, w3, w2, against ``jax.vjp`` of
    the reference's ``moe_ffn``; with and without dropped slots, two
    groups of 16 tokens."""
    jcfg, tcfg = _configs(name, group=16, cf=cf)
    p, x = _weights(jcfg), _x(jcfg)
    rng = np.random.default_rng(4)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    daux = np.float32(0.7)
    got, want = _vjps(jcfg, tcfg, p, x, dy, daux)
    expect = {"x", "router", "we1", "we2", "we3"} | (
        {"w1", "w2", "w3"} if tcfg.moe_shared else set())
    assert set(got) == set(want) == expect
    top1 = tcfg.experts_per_token == 1
    for n in sorted(expect - ({"router"} if top1 else set())):
        _grad_close(got[n], want[n], n)
    assert np.abs(want["router"]).max() > 0
    if top1:
        aux_got, aux_want = _vjps(jcfg, tcfg, p, x, np.zeros_like(dy), daux)
        _grad_close(aux_got["router"], aux_want["router"], "router (aux)")
        for side, full, aux_only in (("port", got, aux_got),
                                     ("reference", want, aux_want)):
            noise = np.abs(full["router"] - aux_only["router"]).max()
            assert noise <= NOISE_REL * np.abs(aux_only["router"]).max(), \
                (side, noise)


# ---------------------------------------------------------------------------
# the client trainer on a MoE decoder
# ---------------------------------------------------------------------------

def test_local_train_on_moe_matches_reference():
    """3 steps of ``make_local_train`` on reduced OLMoE with next-token
    batches (4 x 16 tokens: one group of 64) from the reference's weights
    and live adapters, against the reference's trainer: the mean loss,
    each step's loss at the reference's weights before that step, and the
    trained factors. The aux term reaches the LoRA factors through the
    router's input."""
    jcfg, tcfg = j_get_reduced("olmoe-1b-7b"), get_reduced("olmoe-1b-7b")
    steps, rank = 3, 4
    jparams = j_model.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    for ad in jparams["lora"].values():
        ad["B"] = jnp.asarray(0.05 * rng.standard_normal(ad["B"].shape),
                              jnp.float32)
    mask = (np.arange(jcfg.lora.r_max) < rank).astype(np.float32)
    masks = {t: np.broadcast_to(mask, (jcfg.num_layers, jcfg.lora.r_max)
                                ).copy() for t in jcfg.lora.targets}
    jfrozen, jhead = j_client.split_head(jparams)
    jfactors, _ = j_client.split_adapters(jparams["lora"])
    trainable = jax.tree.map(np.asarray, {"factors": jfactors,
                                          "head": jhead})
    data = make_bigram_lm(steps * 4, 16, tcfg.vocab_size, seed=2)
    data = {k: v.reshape(steps, 4, 16) for k, v in data.items()}

    jtr, jloss = j_client.make_local_train(jcfg, j_opt.adamw(LR))(
        jfrozen, jax.tree.map(jnp.asarray, trainable),
        jax.tree.map(jnp.asarray, masks), jax.tree.map(jnp.asarray, data))
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    tfrozen, thead = split_head(tparams)
    assert thead == {} and split_adapters(tparams.lora)[0].keys() == \
        jfactors.keys()
    ttr, tloss = make_local_train(tcfg, t_opt.adamw(LR), device="cpu")(
        tfrozen, interop.tree_from_numpy(trainable, "cpu"),
        interop.tree_from_numpy(masks, "cpu"), data)
    np.testing.assert_allclose(float(tloss), float(jloss), **FWD)
    # the loss carries the aux term: the same batch's loss and metrics
    params = interop.params_from_jax(
        {**jax.tree.map(np.asarray, jfrozen),
         "lora": j_client.join_adapters(
             jax.tree.map(np.asarray, jfactors), masks)}, tcfg, device="cpu")
    batch = {k: v[0] for k, v in data.items()}
    with torch.no_grad():
        _, m_t = t_model.loss_fn(params, {k: _t(v) for k, v in
                                          batch.items()}, tcfg, remat=False)
    _, m_j = j_model.loss_fn({**jfrozen, "lora": j_client.join_adapters(
        jfactors, jax.tree.map(jnp.asarray, masks))},
        jax.tree.map(jnp.asarray, batch), jcfg, remat=False)
    assert float(m_t["aux"]) > 0
    for k in ("loss", "nll", "aux"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5,
                                   err_msg=k)
    ttr = interop.tree_to_numpy(ttr)
    jtr = jax.tree.map(np.asarray, jtr)

    def check(g, w, i):
        np.testing.assert_allclose(g, w, **TRAINED)
        change = np.linalg.norm(w - i)
        assert change > 0
        assert np.linalg.norm(g - w) <= 1e-3 * change

    jax.tree.map(check, ttr["factors"], jtr["factors"],
                 trainable["factors"])
    for t in masks:         # masked rank directions stay as they were
        dead = mask == 0
        np.testing.assert_array_equal(ttr["factors"][t]["A"][..., dead],
                                      trainable["factors"][t]["A"][..., dead])
