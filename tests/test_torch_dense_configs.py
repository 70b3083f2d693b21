"""The last three reference configs in the port, on the CPU: Chameleon-34B
(``vlm``: the dense decoder over early-fused token ids, GQA 4 on 2 in the
reduced shape), Granite-34B (biases, a plain GELU MLP, one KV head) and
Command-R+ (GQA, no bias), each at its reduced shape (2 layers, d_model
128, heads of 32).

Both packages start from the reference's own seed-0 weights and demo
adapters (``repro_torch.interop``) and the same numpy inputs; Granite's
biases, which the reference initialises to zero, are drawn from numpy
(std ``BIAS_STD``) on both sides, so that its bias path carries numbers.

Tolerances, float32 throughout:
- configs, ``ARCH_IDS`` and aliases: equal;
- ``forward``'s logits and ``decode_step``'s logits: rtol 1e-4, atol 1e-4
  (``tests/test_torch_model.py``'s: the same products summed in another
  order through 2 layers, logits O(1));
- ``loss_fn``'s loss: rtol 1e-5 (one log-sum-exp over those logits);
- ``ServeEngine``: greedy tokens and scheduler counts equal to the
  reference engine's (its plain path and its Pallas kernels in interpret
  mode) and to the port's merged-weight oracle, as
  ``tests/test_torch_serve.py`` holds Gemma-2B and Minitron-4B;
- Granite's speculative wave (forced-accept and n-gram drafters): tokens,
  speculation and scheduler counts equal to the reference's speculative
  engine and to the port's plain decode, as ``tests/test_torch_spec.py``.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serve import STEPS as SERVE_STEPS
from test_torch_serve import Fixture as ServeFixture
from test_torch_serve import _run as serve_run
from test_torch_spec import STEPS as SPEC_STEPS
from test_torch_spec import _assert_same_run, _drafters, _fixture
from test_torch_spec import _run as spec_run
from test_torch_spec import _scripts

from repro.configs import base as j_base
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.models import model as j_model
from repro.serve.oracle import make_demo_adapter as j_demo_adapter
from repro_torch import configs as t_configs
from repro_torch import interop
from repro_torch.configs import base as t_base
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import model as t_model
from repro_torch.serve.oracle import merged_greedy

NAMES = ("chameleon-34b", "granite-34b", "command-r-plus-104b")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
BIAS_STD = 0.1


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


def _with_live_biases(params, cfg):
    """The reference initialises every bias to zero, so a biased config
    would compute its bias adds on zeros: draw each attention and MLP bias
    from N(0, BIAS_STD^2) with numpy instead (Granite's q/k/v/o and
    w1/w2 biases), so that both sides carry the same live numbers."""
    if not cfg.use_bias:
        return params
    rng = np.random.default_rng(17)
    for group in ("attn", "mlp"):
        leaves = params["layers"][group]
        for name in sorted(leaves):
            if name.startswith("b"):
                leaves[name] = jnp.asarray(BIAS_STD * rng.standard_normal(
                    leaves[name].shape), leaves[name].dtype)
    return params


@contextlib.contextmanager
def _reference_init_with_live_biases():
    """While fixtures of other test files build the reference's weights,
    its ``init_params`` gives live biases (``_with_live_biases``)."""
    init = j_model.init_params

    def biased(key, cfg, *args, **kw):
        return _with_live_biases(init(key, cfg, *args, **kw), cfg)

    j_model.init_params = biased
    try:
        yield
    finally:
        j_model.init_params = init


_ARCHS = {}


def _arch(name):
    """The reference's seed-0 weights with a live rank-6 demo adapter on
    every target, in both packages."""
    if name not in _ARCHS:
        jcfg, tcfg = j_get_reduced(name), get_reduced(name)
        key = jax.random.PRNGKey(0)
        jparams = _with_live_biases(j_model.init_params(key, jcfg), jcfg)
        jparams["lora"] = j_demo_adapter(jax.random.fold_in(key, 7), jcfg, 6)
        tparams = interop.params_from_jax(jax.tree.map(np.asarray, jparams),
                                          tcfg, device="cpu")
        _ARCHS[name] = (jcfg, tcfg, jparams, tparams)
    return _ARCHS[name]


_SERVE = {}


def _serve(name):
    if name not in _SERVE:
        with _reference_init_with_live_biases():
            _SERVE[name] = ServeFixture(name)
    return _SERVE[name]


@pytest.mark.parametrize("name", NAMES)
def test_config_fields_match_reference(name):
    """Every field the port's ``ModelConfig`` and ``LoRAConfig`` have
    equals the reference's, full and reduced; ``source`` as the reference
    gives it."""
    for jc, tc in ((j_get_config(name), get_config(name)),
                   (j_get_reduced(name), get_reduced(name))):
        for f in dataclasses.fields(tc):
            if f.name != "lora":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        for f in dataclasses.fields(tc.lora):
            assert getattr(tc.lora, f.name) == getattr(jc.lora, f.name)
    assert get_config(name).source == j_get_config(name).source != ""


def test_arch_ids_and_aliases_match_reference():
    """``ARCH_IDS`` and ``list_archs()`` are the reference's, in its order;
    every alias resolves to the same module name, and all 11 configs
    resolve in the port, full and reduced, under the reference's names and
    families (their parameter counts:
    ``tests/test_torch_model.py::test_param_count_matches_reference``)."""
    assert t_base.ARCH_IDS == j_base.ARCH_IDS
    assert t_configs.ARCH_IDS == j_base.ARCH_IDS
    assert t_configs.list_archs() == j_base.list_archs()
    assert t_base._ALIASES == j_base._ALIASES
    for arch in j_base.ARCH_IDS:
        assert t_configs.canonical(arch) == j_base.canonical(arch)
        for get, j_get in ((get_config, j_get_config),
                           (get_reduced, j_get_reduced)):
            tc, jc = get(arch), j_get(arch)
            assert (tc.name, tc.arch_type) == (jc.name, jc.arch_type)
    for alias in j_base._ALIASES:
        assert get_config(alias).name == j_get_config(alias).name


@pytest.mark.parametrize("name", NAMES)
def test_forward_and_loss_match_reference(name):
    """``forward``'s logits and ``loss_fn``'s loss (next-token labels, one
    position unscored) on 2 x 12 tokens, with a live adapter."""
    jcfg, tcfg, jparams, tparams = _arch(name)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": _t(toks), "labels": _t(labels)}
    jl, _ = j_model.forward(jparams, jb, jcfg)
    tl, aux = t_model.forward(tparams, tb, tcfg)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               **LOGIT_TOL)
    assert float(aux) == 0.0
    jloss, _ = j_model.loss_fn(jparams, jb, jcfg)
    tloss, metrics = t_model.loss_fn(tparams, tb, tcfg)
    assert float(tloss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert float(metrics["nll"]) == pytest.approx(float(jloss),
                                                  rel=LOSS_RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_logits_match_reference(name):
    """6 tokens through ``decode_step`` on both sides, with a live
    adapter: the logits at every step and the cache after."""
    jcfg, tcfg, jparams, tparams = _arch(name)
    rng = np.random.default_rng(5)
    toks = rng.integers(3, jcfg.vocab_size, (2, 6)).astype(np.int32)
    jcache = j_model.init_cache(jcfg, 2, 8, jnp.float32)
    tcache = t_model.init_cache(tcfg, 2, 8, torch.float32, device="cpu")
    j_step = jax.jit(j_model.decode_step, static_argnames=("cfg",))
    for t in range(toks.shape[1]):
        jl, jcache = j_step(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.int32(t), cfg=jcfg)
        tl, tcache = t_model.decode_step(tparams, tcache,
                                         _t(toks[:, t:t + 1]), t, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_engine_tokens_equal_reference_engine(name, use_pallas):
    """8 ragged requests over 4 adapters of ranks 2/4/6/8, multi-chunk
    prefill and page-boundary crossings (``tests/test_torch_serve.py``'s
    traffic): identical greedy tokens and scheduler counts."""
    fx = _serve(name)
    kw = dict(max_batch=8, max_seq=24, page_size=4, prefill_chunk=4)
    jeng, teng = fx.engines(use_pallas=use_pallas, **kw)
    jout = serve_run(jeng, fx.prompts, SERVE_STEPS)
    tout = serve_run(teng, fx.prompts, SERVE_STEPS)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t, j)
    assert (teng.steps, teng.prefill_calls, teng.tokens_generated) == \
        (jeng.steps, jeng.prefill_calls, jeng.tokens_generated)
    teng.kv.allocator.check()
    assert teng.kv.allocator.free_count == teng.kv.num_pages


@pytest.mark.parametrize("name", NAMES)
def test_engine_matches_port_oracle(name):
    """The port's merged-weight oracle gives the engine's tokens."""
    fx = _serve(name)
    _, teng = fx.engines(max_batch=4, max_seq=24, page_size=4,
                         prefill_chunk=4)
    outs = serve_run(teng, fx.prompts[:4], SERVE_STEPS)
    for i, out in enumerate(outs):
        want = merged_greedy(fx.tparams, fx.tcfg, fx.prompts[i],
                             fx.tadapters[f"client{i}"], SERVE_STEPS)
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("kind", ["accept", "ngram2"])
def test_granite_spec_wave_equals_reference_and_plain(kind):
    """Granite's biased, GELU, one-KV-head decoder through the speculative
    engine (spec_k 4, chunks of 4): tokens equal to the reference's
    speculative engine and to the port's plain decode, with equal
    speculation and scheduler counts."""
    with _reference_init_with_live_biases():
        fx = _fixture("granite-34b")
    jd, td = _drafters(kind)
    jeng, teng = fx.engines(jd, td, spec_k=4, prefill_chunk=4)
    scripts = _scripts(kind, fx.plain, fx.jcfg.vocab_size)
    jout = spec_run(jeng, fx.prompts, scripts)
    tout = spec_run(teng, fx.prompts, scripts)
    _assert_same_run(jeng, teng, jout, tout, fx.plain)
    if kind == "accept":
        stats = teng.spec_stats()
        assert stats["accepted"] == stats["drafted"] > 0
        assert teng.spec_dispatches < SPEC_STEPS - 1
