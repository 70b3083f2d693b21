"""The port's model functions against the reference's, on the CPU.

Inputs are made with numpy and weights are the reference's own
(``repro.models.model.init_params``) carried over by
``repro_torch.interop``, so both sides compute on identical numbers.
Everything is float32; tolerances cover summation order only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core import lora as j_lora
from repro.models import common as j_common
from repro.models import model as j_model
from repro.serve.oracle import make_demo_adapter as j_demo_adapter
from repro_torch import interop
from repro_torch.configs import get_reduced
from repro_torch.core import lora as t_lora
from repro_torch.models import common as t_common
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_tf

DENSE_ARCHS = ("gemma-2b", "minitron-4b")  # MQA + GeGLU, GQA (Hkv=2) + SiLU
# top-2 of 4 experts; top-1 of 4 with the shared expert (GQA, Hkv=2)
MOE_ARCHS = ("olmoe-1b-7b", "llama4-maverick-400b-a17b")
ARCHS = DENSE_ARCHS + MOE_ARCHS
MOE_FIELDS = ("num_experts", "experts_per_token", "moe_d_ff", "moe_shared",
              "moe_group_size", "moe_capacity_factor", "arch_type")


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


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _arch(name):
    jcfg, tcfg = j_get_reduced(name), get_reduced(name)
    key = jax.random.PRNGKey(0)
    jparams = j_model.init_params(key, jcfg)
    # a live adapter on every target, so decode exercises the LoRA path
    jparams["lora"] = j_demo_adapter(jax.random.fold_in(key, 7), jcfg, 6)
    tparams = interop.params_from_jax(_np_tree(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return _arch(request.param)


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def dense_arch(request):
    return _arch(request.param)


def test_configs_match_reference():
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config
    for name in ARCHS:
        for jc, tc in ((j_get_reduced(name), get_reduced(name)),
                       (j_get_config(name), get_config(name))):
            for field in ("num_layers", "d_model", "num_heads",
                          "num_kv_heads", "d_ff", "vocab_size",
                          "resolved_head_dim", "activation",
                          "tie_embeddings", "rope_theta") + MOE_FIELDS:
                assert getattr(jc, field) == getattr(tc, field), field
            assert jc.lora.targets == tc.lora.targets
            assert (jc.lora.r_max, jc.lora.alpha) == (tc.lora.r_max,
                                                      tc.lora.alpha)
            assert jc.param_count() == tc.param_count()
            assert jc.active_param_count() == tc.active_param_count()


def test_rms_norm_and_layer_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16), dtype=np.float32) * 3
    w = rng.standard_normal(16, dtype=np.float32)
    b = rng.standard_normal(16, dtype=np.float32)
    np.testing.assert_allclose(
        t_common.rms_norm(_t(x), _t(w)).numpy(),
        np.asarray(j_common.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        t_common.layer_norm(_t(x), _t(w), _t(b)).numpy(),
        np.asarray(j_common.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)


def test_rope_and_sinusoidal_positions():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 32), dtype=np.float32)
    pos = rng.integers(0, 300, (2, 6)).astype(np.int32)
    # angles up to ~300 rad: cos/sin of large float32 arguments differ in
    # the last few ulp between libraries
    np.testing.assert_allclose(
        t_common.rope(_t(x), _t(pos), 10000.0).numpy(),
        np.asarray(j_common.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        t_common.sinusoidal_positions(_t(pos), 16).numpy(),
        np.asarray(j_common.sinusoidal_positions(jnp.asarray(pos), 16)),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal,window,valid", [
    (True, None, False), (True, 3, False), (False, None, True)])
def test_masked_attention(causal, window, valid):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 4, 8), dtype=np.float32)
    k = rng.standard_normal((2, 9, 2, 8), dtype=np.float32)
    v = rng.standard_normal((2, 9, 2, 8), dtype=np.float32)
    kv_valid = rng.random((2, 9)) < 0.7 if valid else None
    kv_valid_j = None if kv_valid is None else jnp.asarray(kv_valid)
    kv_valid_t = None if kv_valid is None else _t(kv_valid)
    got = t_common.attention(_t(q), _t(k), _t(v), causal=causal,
                             window=window, q_offset=5, kv_valid=kv_valid_t)
    want = j_common.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, q_offset=5,
                              kv_valid=kv_valid_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_geglu_and_silu_mlp(dense_arch):
    jcfg, tcfg, jparams, tparams = dense_arch
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, jcfg.d_model), dtype=np.float32)
    jl = jax.tree.map(lambda a: a[0], jparams["layers"]["mlp"])
    got = t_common.mlp(_t(x), tparams.layer(0)["mlp"], tcfg)
    want = j_common.mlp(jnp.asarray(x), jl, jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_lora_delta_and_merge():
    rng = np.random.default_rng(4)
    ad = {"A": rng.standard_normal((3, 12, 8), dtype=np.float32),
          "B": rng.standard_normal((3, 8, 10), dtype=np.float32),
          "mask": np.asarray(j_lora.make_rank_mask(5, 8))[None].repeat(3, 0)}
    w0 = rng.standard_normal((3, 12, 10), dtype=np.float32)
    jad = {k: jnp.asarray(v) for k, v in ad.items()}
    tad = {k: _t(v) for k, v in ad.items()}
    np.testing.assert_allclose(
        t_lora.merge(_t(w0), tad, 16.0).numpy(),
        np.asarray(j_lora.merge(jnp.asarray(w0), jad, 16.0)), rtol=1e-5,
        atol=1e-5)
    x = rng.standard_normal((3, 4, 12), dtype=np.float32)
    np.testing.assert_allclose(
        t_lora.apply_lora(_t(x), _t(w0), tad, 16.0).numpy(),
        np.asarray(j_lora.apply_lora(jnp.asarray(x), jnp.asarray(w0), jad,
                                     16.0)), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(t_lora.make_rank_mask(5, 8).numpy(),
                                  np.asarray(j_lora.make_rank_mask(5, 8)))


def test_decode_step_logits_match(arch):
    jcfg, tcfg, jparams, tparams = arch
    rng = np.random.default_rng(5)
    toks = rng.integers(3, jcfg.vocab_size, (2, 6)).astype(np.int32)
    jcache = j_model.init_cache(jcfg, 2, 8, jnp.float32)
    tcache = t_model.init_cache(tcfg, 2, 8, torch.float32, device="cpu")
    j_step = jax.jit(j_model.decode_step, static_argnames=("cfg",))
    for t in range(toks.shape[1]):
        jl, jcache = j_step(jparams, jcache,
                            jnp.asarray(toks[:, t:t + 1]), jnp.int32(t),
                            cfg=jcfg)
        tl, tcache = t_model.decode_step(tparams, tcache,
                                         _t(toks[:, t:t + 1]), t, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=1e-4, atol=1e-5)


def test_init_params_shapes_and_scales(arch):
    jcfg, tcfg, jparams, _ = arch
    p = t_model.init_params(tcfg, seed=0, device="cpu")
    jl = jparams["layers"]
    for g in t_tf.Transformer.GROUPS:
        for name, arr in jl[g].items():
            got = getattr(p.layers[g], name)
            assert tuple(got.shape) == arr.shape, (g, name)
    assert tuple(p.embed.shape) == jparams["embed"].shape
    assert set(p.lora) == set(jparams["lora"])
    # std 1/sqrt(d_in) projections, 0.02 embedding, zero norm weights
    wq = p.layers["attn"].wq
    assert abs(float(wq.std()) * tcfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(float(p.embed.std()) / 0.02 - 1.0) < 0.05
    assert not p.layers["ln1"].w.any()
    if tcfg.num_experts:
        # the reference's MoE draws: router, we1, we3 std 1/sqrt(d), we2
        # std 1/sqrt(ff)
        mp = p.layers["mlp"]
        for name, fan_in in (("router", tcfg.d_model),
                             ("we1", tcfg.d_model), ("we3", tcfg.d_model),
                             ("we2", tcfg.moe_d_ff)):
            std = float(getattr(mp, name).std()) * fan_in ** 0.5
            assert abs(std - 1.0) < 0.05, name
    same = t_model.init_params(tcfg, seed=0, device="cpu")
    for name in jl["mlp"]:
        assert torch.equal(getattr(same.layers["mlp"], name),
                           getattr(p.layers["mlp"], name)), name


def test_non_dense_families_raise():
    cfg = get_reduced("gemma-2b").with_(arch_type="ssm")
    with pytest.raises(NotImplementedError):
        t_model.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        t_model.init_cache(cfg, 1, 4, device="cpu")


def test_interop_carries_moe_leaves_one_to_one():
    """The reference's MoE ``mlp`` leaves (router (L, d, E), we1/we3 (L, E,
    d, ff), we2 (L, E, ff, d), Llama-4's shared w1/w3 (L, d, d_ff) and w2)
    come across under the same names, shapes and values, and go back
    unchanged."""
    for name in MOE_ARCHS:
        jcfg, tcfg, jparams, tparams = _arch(name)
        want = _np_tree(jparams["layers"]["mlp"])
        L, d, e = tcfg.num_layers, tcfg.d_model, tcfg.num_experts
        ff = tcfg.moe_d_ff
        shapes = {"router": (L, d, e), "we1": (L, e, d, ff),
                  "we3": (L, e, d, ff), "we2": (L, e, ff, d)}
        if tcfg.moe_shared:
            shapes.update(w1=(L, d, tcfg.d_ff), w3=(L, d, tcfg.d_ff),
                          w2=(L, tcfg.d_ff, d))
        got = tparams.layers["mlp"].as_dict()
        assert sorted(got) == sorted(want) == sorted(shapes)
        for k, w in want.items():
            assert tuple(got[k].shape) == w.shape == shapes[k], k
            assert np.array_equal(got[k].numpy(), w), k
        back = interop.tree_to_numpy(tparams.tree())["layers"]["mlp"]
        for k, w in want.items():
            assert back[k].dtype == w.dtype and np.array_equal(back[k], w), k


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_forward_matches_reference(name):
    """``forward``'s logits and summed aux against the reference's on a
    MoE decoder (2 x 12 tokens: one group of 24, slots dropped at 1.25)."""
    jcfg, tcfg, jparams, tparams = _arch(name)
    toks = np.random.default_rng(6).integers(
        3, jcfg.vocab_size, (2, 12)).astype(np.int32)
    lj, aj = j_model.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                             remat=False)
    with torch.no_grad():
        lt, at = t_model.forward(tparams, {"tokens": _t(toks)}, tcfg,
                                 remat=False)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    assert at.dtype == torch.float32 and float(at) > 0
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_decode_matches_forward(name):
    """Teacher-forced decode equals the parallel forward at capacity 8.0,
    where no slot is dropped (the reference's
    ``tests/test_models.py::test_decode_matches_forward``: capacity drops
    depend on the group, which is the whole sequence in ``forward`` and
    the batch's rows in decode), within the reference test's 2e-3 of the
    logits' largest magnitude."""
    jcfg, tcfg, jparams, tparams = _arch(name)
    tcfg = tcfg.with_(moe_capacity_factor=8.0)
    toks = _t(np.random.default_rng(7).integers(
        3, tcfg.vocab_size, (2, 10)).astype(np.int32))
    with torch.no_grad():
        logits, _ = t_model.forward(tparams, {"tokens": toks}, tcfg,
                                    remat=False)
    cache = t_model.init_cache(tcfg, 2, 10, torch.float32, device="cpu")
    errs = []
    for t in range(toks.shape[1]):
        lg, cache = t_model.decode_step(tparams, cache, toks[:, t:t + 1], t,
                                        tcfg)
        errs.append(float((lg - logits[:, t]).abs().max()))
    scale = float(logits.abs().max())
    assert max(errs) < 2e-3 * max(scale, 1.0), errs


def test_serve_engine_refuses_moe():
    """The engine serves the dense family only, as the reference's does:
    an ``arch_type="moe"`` config and a dense config with experts both
    raise ``NotImplementedError``."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.registry import AdapterRegistry

    tcfg = get_reduced("olmoe-1b-7b")
    params = t_model.init_params(tcfg, device="cpu")
    registry = AdapterRegistry(tcfg, capacity=1, device="cpu")
    with pytest.raises(NotImplementedError, match="dense transformer"):
        ServeEngine(params, tcfg, registry, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE serving not wired"):
        ServeEngine(params, tcfg.with_(arch_type="dense"), registry,
                    device="cpu")
