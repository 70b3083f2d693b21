"""The port's server aggregation against the reference's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages: the
``recon_agg`` op (its plain version; the CUDA kernel is held to the same
plain version on the card by ``chip_smoke.py``), the SVD back-ends,
``core/aggregate.py``, the batched engine, and the slice as a whole (two
local steps of a cohort on roberta-reduced from the reference's weights,
then aggregation).

SVD factors are defined only up to a joint sign per direction, and
directions with σ = 0 are arbitrary, so results are compared by spectra
and by each client's effective update s'_k (A'_k m_k)(B'_k m_k), never by
raw factors. Tolerances, float32 throughout (every elementwise check
also has an absolute floor of 1e-6 of the largest reference value):
- ``recon_agg``, the dense reconstructions, naive averaging, Eq. 1's
  bias and ``truncation_error``: rtol 1e-5 (sums of Kc·R products in
  another order);
- ``reconstruct_factored`` and ``split_factors``: rtol 1e-6 (products
  and square roots of the same numbers, no sums);
- ``_cholqr2``'s R and R⁻¹: normwise 1e-5 (the same algorithm on each
  item), and its Q orthonormal to atol 1e-3;
- spectra: rtol 1e-4, atol 1e-6 of σ_1; updates: normwise 1e-4 of the
  reference's, where both sides run the same algorithm, and 1e-3 where
  the Gram path meets Householder QR or a dense SVD (the shifted
  CholeskyQR2's own float32 error is ~1e-5, the reference's docstring);
- the slice as a whole: the same 1e-4 (the trained factors already
  differ by float32 reordering through two encoder layers and two Adam
  steps, ~1e-6 relative, and the SVD moves that by at most 1/relative
  gap);
- ``rank_for_energy``: bit-identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core import agg_engine as j_engine
from repro.core import aggregate as j_agg
from repro.core import svd as j_svd
from repro.fed import client as j_client
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import model as j_model
from repro.optim import optimizers as j_opt
from repro_torch import interop
from repro_torch.configs import get_reduced
from repro_torch.core import agg_engine as t_engine
from repro_torch.core import aggregate as t_agg
from repro_torch.core import svd as t_svd
from repro_torch.data import client_batches, make_pair_classification
from repro_torch.fed import make_cohort_train, split_head
from repro_torch.kernels import _build, ops
from repro_torch.kernels import recon_agg as recon_mod
from repro_torch.kernels import ref as t_ref
from repro_torch.optim import optimizers as t_opt

ALPHA = 16.0
RECON = dict(rtol=1e-5)
SPEC = dict(rtol=1e-4)


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
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def _close(got, want, rtol, what=""):
    """Elementwise within rtol, with an absolute floor of 1e-6 of the
    largest reference value."""
    got, want = np.asarray(got), np.asarray(want)
    floor = 1e-6 * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor,
                               err_msg=what)


def _normwise(got, want, rel, what=""):
    """||got - want|| <= rel ||want|| over the last two axes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    num = np.linalg.norm(got - want, axis=(-2, -1))
    den = np.maximum(np.linalg.norm(want, axis=(-2, -1)), 1e-30)
    assert (num / den).max() <= rel, (what, (num / den).max())


def _stacked(rng, k=3, d_in=24, d_out=20, r_max=8, ranks=(2, 4, 8),
             layers=None):
    """Client-stacked adapters (numpy): gaussian A (std 1/sqrt(d_in)),
    B of 0.1, both masked to each client's rank."""
    stack = () if layers is None else (layers,)
    a = rng.standard_normal((k, *stack, d_in, r_max)) / np.sqrt(d_in)
    b = 0.1 * rng.standard_normal((k, *stack, r_max, d_out))
    mask = np.stack([np.broadcast_to(
        (np.arange(r_max) < r).astype(np.float32), (*stack, r_max))
        for r in ranks])
    return {"A": (a * mask[..., None, :]).astype(np.float32),
            "B": (b * mask[..., :, None]).astype(np.float32),
            "mask": mask.astype(np.float32)}


def _tree(seed, layers=None):
    """Three targets, two leaf shapes: q and v group together, w2 alone."""
    rng = np.random.default_rng(seed)
    return {"q": _stacked(rng, layers=layers),
            "v": _stacked(rng, ranks=(8, 3, 5), layers=layers),
            "w2": _stacked(rng, d_in=40, d_out=24, ranks=(6, 2, 4),
                           layers=layers)}


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ttree(tree):
    return {t: {k: _t(v) for k, v in ad.items()} for t, ad in tree.items()}


def _updates(ad):
    """Each client's effective update s_k (A_k m_k)(B_k m_k), numpy."""
    ad = _np(ad)
    m = ad["mask"]
    scale = ALPHA / np.maximum(m.sum(-1), 1.0)
    a, b = ad["A"] * m[..., None, :], ad["B"] * m[..., :, None]
    return scale[..., None, None] * (a.astype(np.float64)
                                     @ b.astype(np.float64))


def _assert_hlora_close(got, want, rel, spec_got=None, spec_want=None):
    for t in want:
        np.testing.assert_array_equal(_np(got[t]["mask"]),
                                      _np(want[t]["mask"]))
        _normwise(_updates(got[t]), _updates(want[t]), rel, t)
        if spec_want is not None:
            _close(_np(spec_got[t]), _np(spec_want[t]), SPEC["rtol"], t)


# ---------------------------------------------------------------------------
# (1) recon_agg: the plain version against the reference and its Pallas
# kernel in interpret mode; the launcher's refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kc,d,r,n", [(1, 128, 8, 128), (5, 256, 16, 128),
                                      (20, 128, 8, 256), (3, 37, 5, 29)])
def test_recon_agg_matches_reference_and_pallas_interpret(kc, d, r, n):
    rng = np.random.default_rng(kc * 1000 + d)
    a = rng.standard_normal((kc, d, r), dtype=np.float32)
    b = rng.standard_normal((kc, r, n), dtype=np.float32)
    eta = rng.dirichlet(np.ones(kc)).astype(np.float32)
    got = ops.recon_agg(_t(a), _t(b), _t(eta)).numpy()
    assert got.shape == (d, n) and got.dtype == np.float32
    want = np.asarray(j_ref.recon_agg_ref(jnp.asarray(a), jnp.asarray(b),
                                          jnp.asarray(eta)))
    _close(got, want, **RECON)
    pallas = np.asarray(j_ops.recon_agg(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(eta), block_m=128,
                                        block_n=128, interpret=True))
    _close(got, pallas, **RECON)
    _close(t_ref.recon_agg_ref(_t(a), _t(b), _t(eta)).numpy(), want, **RECON)


def test_recon_agg_batched_form_equals_a_loop_of_items():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((6, 4, 33, 5), dtype=np.float32)
    b = rng.standard_normal((6, 4, 5, 17), dtype=np.float32)
    eta = rng.random((6, 4), dtype=np.float32)
    got = ops.recon_agg(_t(a), _t(b), _t(eta))
    assert got.shape == (6, 33, 17)
    for i in range(6):
        _close(got[i].numpy(),
               ops.recon_agg(_t(a[i]), _t(b[i]), _t(eta[i])).numpy(),
               **RECON)
        _close(got[i].numpy(), np.asarray(j_ref.recon_agg_ref(
            jnp.asarray(a[i]), jnp.asarray(b[i]), jnp.asarray(eta[i]))),
            **RECON)


def test_cpu_recon_agg_runs_the_plain_version_without_building(monkeypatch):
    def no_build():
        raise AssertionError("a CPU call must not build or load kernels")

    monkeypatch.setattr(_build, "load", no_build)
    before = dict(ops.LAUNCHES)
    a, b, eta = torch.randn(2, 3, 8, 4), torch.randn(2, 3, 4, 5), \
        torch.rand(2, 3)
    torch.testing.assert_close(ops.recon_agg(a, b, eta),
                               recon_mod.recon_agg_plain(a, b, eta))
    tree = _ttree(_tree(0, layers=2))
    t_engine.AggregationEngine()(tree, torch.ones(3), ALPHA, method="exact")
    assert ops.LAUNCHES == before
    assert "recon_agg" in ops.LAUNCHES


@pytest.mark.parametrize("method", ["exact", "randomized"])
def test_engine_hands_recon_agg_contiguous_operands(monkeypatch, method):
    """The kernel's launcher takes contiguous operands only. A shape group
    of one target over a layer stack (w2 here) is where stacking and
    moving the layer axis in front can leave a strided view."""
    seen = []
    plain_op = ops.recon_agg

    def checked(a, b, eta):
        seen.append(tuple(t.is_contiguous() for t in (a, b, eta)))
        return plain_op(a, b, eta)

    monkeypatch.setattr(ops, "recon_agg", checked)
    t_engine.AggregationEngine()(_ttree(_tree(71, layers=3)), torch.ones(3),
                                 ALPHA, method=method)
    assert seen == [(True, True, True)] * 2    # {q, v} and {w2}


@pytest.mark.parametrize("args", [
    (torch.randn(3, 8, 4), torch.randn(3, 5, 6), torch.rand(3)),   # R
    (torch.randn(3, 8, 4), torch.randn(2, 4, 6), torch.rand(3)),   # Kc
    (torch.randn(3, 8, 4), torch.randn(3, 4, 6), torch.rand(2)),   # eta
    (torch.randn(2, 3, 8, 4), torch.randn(2, 3, 4, 6),
     torch.rand(3)),                                               # form
    (torch.randn(8, 4), torch.randn(4, 6), torch.rand(1)),         # ndim
])
def test_recon_agg_rejects_bad_shapes(args):
    with pytest.raises(ValueError):
        ops.recon_agg(*args)


def _batch(r=4, dtype=torch.float32):
    return (torch.randn(1, 3, 8, r).to(dtype), torch.randn(1, 3, r, 6).to(dtype),
            torch.rand(1, 3))


@pytest.mark.parametrize("args,err,match", [
    (_batch(), ValueError, "CUDA"),                          # CPU tensors
    ((torch.randn(1, 3, 8, 4), torch.randn(1, 3, 5, 6), torch.rand(1, 3)),
     ValueError, "mismatch"),                                # R of a and b
    ((torch.randn(1, 3, 8, 4), torch.randn(1, 2, 4, 6), torch.rand(1, 3)),
     ValueError, "mismatch"),                                # Kc
    ((torch.randn(2, 3, 8, 4), torch.randn(2, 3, 4, 6), torch.rand(1, 3)),
     ValueError, "mismatch"),                                # items
    ((torch.randn(3, 8, 4), torch.randn(3, 4, 6), torch.rand(3)),
     ValueError, "batched form"),                            # single item
    (_batch(dtype=torch.bfloat16), TypeError, "float32"),    # bfloat16
    ((*_batch()[:2], torch.rand(1, 3, dtype=torch.float64)), TypeError,
     "float32"),                                             # eta float64
    (_batch(r=0), ValueError, "ranks 1..64"),                # rank 0
    (_batch(r=65), ValueError, "ranks 1..64"),               # rank above 64
    ((torch.zeros(1, 1, 1, 64).expand(1, 65536, 1, 64),
      torch.zeros(1, 1, 64, 1).expand(1, 65536, 64, 1),
      torch.zeros(1, 1).expand(1, 65536)),
     ValueError, "Kc\\*R"),                                  # Kc*R >= 2**22
])
def test_recon_agg_launcher_refuses_what_the_kernel_does_not_take(args, err,
                                                                   match):
    """Checked before the library is touched (``lib`` is None here); the
    CPU tensors of the other cases would be refused too, after these."""
    with pytest.raises(err, match=match):
        recon_mod.launch(None, *args)


# ---------------------------------------------------------------------------
# (2) the SVD back-ends, batched, against the reference per item
# ---------------------------------------------------------------------------

def _factors(rng, n, d_in=40, d_out=32, rr=16):
    p = rng.standard_normal((n, d_in, rr)).astype(np.float32) * 0.1
    q = rng.standard_normal((n, rr, d_out)).astype(np.float32) * 0.1
    return p, q


@pytest.mark.parametrize("r", [4, 8])
@pytest.mark.parametrize("name", ["exact", "factored", "factored_gram"])
def test_svd_backends_match_reference(name, r):
    rng = np.random.default_rng(r)
    p, q = _factors(rng, 3)
    w = p @ q
    if name == "exact":
        got = t_svd.svd_exact(_t(w), r)
        want = [j_svd.svd_exact(jnp.asarray(x), r) for x in w]
    else:
        fn = getattr(t_svd, f"svd_{name}")
        got = fn(_t(p), _t(q), r)
        want = [getattr(j_svd, f"svd_{name}")(jnp.asarray(x), jnp.asarray(y),
                                              r) for x, y in zip(p, q)]
    u, s, vt = (x.numpy() for x in got)
    assert u.shape == (3, 40, r) and s.shape == (3, r) and vt.shape == \
        (3, r, 32)
    for i, (ju, js, jvt) in enumerate(want):
        _close(s[i], np.asarray(js), SPEC["rtol"], f"spectrum {i}")
        _normwise((u[i] * s[i]) @ vt[i],
                  (np.asarray(ju) * np.asarray(js)) @ np.asarray(jvt), 1e-4)


def test_svd_randomized_holds_its_contract_and_matches_reference():
    """Exact to float precision when rank(W) <= r + oversample: the rank-r
    truncation equals the exact SVD's, as the reference's does (its draws
    are jax.random's, so the products are compared, not the draws). The
    same CPU generator state gives the same result."""
    rng = np.random.default_rng(5)
    p, q = _factors(rng, 3, rr=12)
    w = p @ q
    r = 8
    u, s, vt = t_svd.svd_randomized(_t(w), r,
                                    torch.Generator().manual_seed(1))
    eu, es, evt = t_svd.svd_exact(_t(w), r)
    _close(s.numpy(), es.numpy(), SPEC["rtol"])
    _normwise((u * s[..., None, :]) @ vt, (eu * es[..., None, :]) @ evt,
              1e-4)
    for i in range(3):
        ju, js, jvt = j_svd.svd_randomized(jnp.asarray(w[i]), r,
                                           jax.random.PRNGKey(i))
        _normwise(((u * s[..., None, :]) @ vt)[i].numpy(),
                  (np.asarray(ju) * np.asarray(js)) @ np.asarray(jvt), 1e-4)
    again = t_svd.svd_randomized(_t(w), r, torch.Generator().manual_seed(1))
    for x, y in zip((u, s, vt), again):
        assert torch.equal(x, y)


def test_svd_exact_asks_cuda_for_the_qr_based_driver(monkeypatch):
    """On CUDA ``svd_exact`` asks cuSOLVER for ``gesvd``: the default
    there, the Jacobi ``gesvdj``, loses precision on a rank-deficient ΔW.
    On the CPU it passes no driver (the keyword is CUDA-only). Checked
    with a recording stand-in for ``torch.linalg.svd`` and a tensor that
    reports itself as on CUDA."""
    drivers = []
    real_svd = torch.linalg.svd

    def recording_svd(w, full_matrices=True, *, driver=None):
        drivers.append(driver)
        return real_svd(w.as_subclass(torch.Tensor),
                        full_matrices=full_matrices)

    class OnCuda(torch.Tensor):
        is_cuda = True

    monkeypatch.setattr(torch.linalg, "svd", recording_svd)
    w = _t(np.random.default_rng(2).standard_normal((2, 12, 10),
                                                    dtype=np.float32))
    _, s_cuda, _ = t_svd.svd_exact(w.as_subclass(OnCuda), 4)
    _, s_cpu, _ = t_svd.svd_exact(w, 4)
    assert drivers == ["gesvd", None]
    assert torch.equal(s_cuda.as_subclass(torch.Tensor), s_cpu)


@pytest.mark.parametrize("split", ["paper", "sqrt"])
def test_split_factors_and_truncation_error_match_reference(split):
    rng = np.random.default_rng(11)
    p, q = _factors(rng, 2)
    w = p @ q
    u, s, vt = np.linalg.svd(w, full_matrices=False)
    u, s, vt = (x.astype(np.float32) for x in (u, s, vt))
    a, b = t_svd.split_factors(_t(u), _t(s), _t(vt), 6, split)
    ja, jb = j_svd.split_factors(jnp.asarray(u), jnp.asarray(s),
                                 jnp.asarray(vt), 6, split)
    _close(a.numpy(), np.asarray(ja), 1e-6)
    _close(b.numpy(), np.asarray(jb), 1e-6)
    err = t_svd.truncation_error(_t(w), a, b).numpy()
    assert err.shape == (2,)
    for i in range(2):
        want = float(j_svd.truncation_error(jnp.asarray(w[i]), ja[i], jb[i]))
        _close(err[i], want, 1e-5)
    with pytest.raises(ValueError, match="split"):
        t_svd.split_factors(_t(u), _t(s), _t(vt), 6, "halves")


def test_cholqr2_shift_is_per_item():
    """A batch whose items' Grams differ by 1e12 in scale: each item's
    shift is its own ‖G‖∞, so the batched result equals the reference's
    vmap item by item (a shift over the whole batch would bury the small
    item under the large one's)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 30, 6)).astype(np.float32)
    x[0] *= 1e-3
    x[1] *= 1e3
    rinv, r = (t.numpy() for t in t_svd._cholqr2(_t(x), 1e-4))
    jrinv, jr = jax.vmap(lambda v: j_svd._cholqr2(v, 1e-4))(jnp.asarray(x))
    for i in range(2):
        _normwise(r[i], np.asarray(jr[i]), 1e-5, f"R {i}")
        _normwise(rinv[i], np.asarray(jrinv[i]), 1e-5, f"R^-1 {i}")
        q = x[i] @ rinv[i]                 # orthonormal columns
        np.testing.assert_allclose(q.T @ q, np.eye(6), atol=1e-3)


def test_svd_factored_gram_masked_zero_columns_and_wide_factor():
    """Ports of the reference's NaN traps: exactly-zero (masked) columns,
    and d < R, where the Gram of Qᵀ is singular by construction."""
    rng = np.random.default_rng(3)
    p = rng.standard_normal((48, 16)).astype(np.float32) * 0.1
    q = rng.standard_normal((16, 40)).astype(np.float32) * 0.1
    p[:, 4:8] = 0.0
    q[4:8, :] = 0.0
    wide_p = rng.standard_normal((40, 32)).astype(np.float32) * 0.1
    wide_q = rng.standard_normal((32, 24)).astype(np.float32) * 0.1
    for pp, qq in ((p, q), (wide_p, wide_q)):
        u, s, vt = t_svd.svd_factored_gram(_t(pp), _t(qq), 8)
        assert all(bool(torch.isfinite(x).all()) for x in (u, s, vt))
        ju, js, jvt = j_svd.svd_factored(jnp.asarray(pp), jnp.asarray(qq), 8)
        _close(s.numpy(), np.asarray(js), SPEC["rtol"])
        _normwise(((u * s) @ vt).numpy(),
                  (np.asarray(ju) * np.asarray(js)) @ np.asarray(jvt), 1e-3)


def test_engine_gram_survives_a_rank_deficient_cohort():
    """Every client a truncation of one global adapter plus 1e-3 noise: P
    has numerical rank ~r ≪ K·r. The Gram path stays finite and matches
    the QR path and the reference's Gram path."""
    rng = np.random.default_rng(13)
    k, d_in, d_out, r = 10, 64, 48, 8
    a0 = rng.standard_normal((d_in, r)) * 0.05
    b0 = rng.standard_normal((r, d_out)) * 0.05
    tree = {"q": {
        "A": np.stack([a0 + 5e-5 * rng.standard_normal((d_in, r))
                       for _ in range(k)]).astype(np.float32),
        "B": np.stack([b0 + 5e-5 * rng.standard_normal((r, d_out))
                       for _ in range(k)]).astype(np.float32),
        "mask": np.ones((k, r), np.float32)}}
    eta = np.ones(k, np.float32)
    got, spectra = t_engine.AggregationEngine()(_ttree(tree), _t(eta), ALPHA)
    assert all(bool(torch.isfinite(v).all()) for v in got["q"].values())
    assert bool(torch.isfinite(spectra["q"]).all())
    qr, _ = t_engine.AggregationEngine(factored_impl="qr")(
        _ttree(tree), _t(eta), ALPHA)
    _assert_hlora_close(got, qr, 1e-4)
    ref, _ = j_engine.AggregationEngine(use_pallas=False)(
        _jtree(tree), jnp.asarray(eta), ALPHA)
    _assert_hlora_close(got, ref, 1e-4)


# ---------------------------------------------------------------------------
# (3) core/aggregate.py against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [None, 3])
def test_naive_and_reconstructions_match_reference(layers):
    ad = _tree(21, layers)["q"]
    eta = np.array([1.0, 2.0, 3.0], np.float32)
    jad, tad = _jtree({"q": ad})["q"], _ttree({"q": ad})["q"]
    new = np.ones_like(ad["mask"])
    for nm in (None, new):
        got = t_agg.aggregate_naive(tad, _t(eta),
                                    None if nm is None else _t(nm))
        want = j_agg.aggregate_naive(jad, jnp.asarray(eta),
                                     None if nm is None else jnp.asarray(nm))
        for leaf in ("A", "B"):
            _close(got[leaf].numpy(), np.asarray(want[leaf]), 1e-5, leaf)
        np.testing.assert_array_equal(got["mask"].numpy(),
                                      np.asarray(want["mask"]))
    _close(t_agg.reconstruct_global_update(tad, _t(eta), ALPHA).numpy(),
           np.asarray(j_agg.reconstruct_global_update(jad, jnp.asarray(eta),
                                                      ALPHA)), **RECON)
    for g, w in zip(t_agg.reconstruct_factored(tad, _t(eta), ALPHA),
                    j_agg.reconstruct_factored(jad, jnp.asarray(eta), ALPHA)):
        _close(g.numpy(), np.asarray(w), 1e-6)
    bias = float(t_agg.aggregation_bias(tad, _t(eta), ALPHA))
    _close(bias, float(j_agg.aggregation_bias(jad, jnp.asarray(eta), ALPHA)),
           1e-5)
    assert bias > 0
    one = {k: v[:1] for k, v in tad.items()}
    assert float(t_agg.aggregation_bias(one, torch.ones(1), ALPHA)) < 1e-6


@pytest.mark.parametrize("split", ["paper", "sqrt"])
@pytest.mark.parametrize("method", ["factored", "exact", "randomized"])
def test_aggregate_hlora_matches_reference(method, split):
    """Randomized: Σ r_k = 14 <= r_max + oversample = 16, so both sides
    are exact whatever their draws."""
    ad = _tree(31, layers=2)["q"]
    eta = np.array([3.0, 1.0, 2.0], np.float32)
    new = np.stack([np.broadcast_to((np.arange(8) < r).astype(np.float32),
                                    (2, 8)) for r in (8, 2, 5)])
    got = t_agg.aggregate_hlora(_ttree({"q": ad})["q"], _t(eta), ALPHA,
                                _t(new), method=method, split=split,
                                gen=torch.Generator().manual_seed(0))
    want = j_agg.aggregate_hlora(_jtree({"q": ad})["q"], jnp.asarray(eta),
                                 ALPHA, jnp.asarray(new), method=method,
                                 split=split, key=jax.random.PRNGKey(0))
    _assert_hlora_close({"q": got}, {"q": want}, 1e-4)


@pytest.mark.parametrize("strategy", ["naive", "hlora"])
def test_aggregate_tree_and_its_reference_loop_match_reference(strategy):
    tree = _tree(41, layers=2)
    eta = np.array([1.0, 1.0, 2.0], np.float32)
    want = j_agg.aggregate_tree_reference(_jtree(tree), jnp.asarray(eta),
                                          ALPHA, strategy=strategy)
    for fn in (t_agg.aggregate_tree, t_agg.aggregate_tree_reference):
        got = fn(_ttree(tree), _t(eta), ALPHA, strategy=strategy)
        if strategy == "hlora":
            # the engine's default is the Gram path, the loop's QR
            _assert_hlora_close(got, want, 1e-3)
        else:
            for t in want:
                for leaf in ("A", "B", "mask"):
                    _close(_np(got[t][leaf]), _np(want[t][leaf]), 1e-5)
    with pytest.raises(ValueError, match="strategy"):
        t_agg.aggregate_tree_reference(_ttree(tree), _t(eta), ALPHA,
                                       strategy="mean")


# ---------------------------------------------------------------------------
# (4) the batched engine against the reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [None, 3])
@pytest.mark.parametrize("split", ["paper", "sqrt"])
@pytest.mark.parametrize("strategy,method", [
    ("naive", "factored"), ("hlora", "gram"), ("hlora", "qr"),
    ("hlora", "exact"), ("hlora", "randomized")])
def test_engine_matches_reference_engine(strategy, method, split, layers):
    """Randomized: every target's Σ r_k <= r_max + oversample = 16, so both
    sides are exact whatever their draws."""
    tree = _tree(51, layers)
    eta = np.array([2.0, 1.0, 1.0], np.float32)
    svd = "factored" if method in ("gram", "qr") else method
    impl = method if method in ("gram", "qr") else "gram"
    kw = dict(strategy=strategy, method=svd, split=split)
    got, spec = t_engine.AggregationEngine(factored_impl=impl)(
        _ttree(tree), _t(eta), ALPHA, **kw)
    want, jspec = j_engine.AggregationEngine(
        use_pallas=False, factored_impl=impl)(
        _jtree(tree), jnp.asarray(eta), ALPHA, **kw)
    stack = () if layers is None else (layers,)
    assert spec["q"].shape == (*stack, 8)
    for t in tree:
        assert got[t]["A"].shape == tree[t]["A"].shape
        assert got[t]["B"].shape == tree[t]["B"].shape
    if strategy == "hlora":
        _assert_hlora_close(got, want, 1e-4, spec, jspec)
        return
    for t in tree:
        assert not spec[t].any() and not np.asarray(jspec[t]).any()
        for leaf in ("A", "B", "mask"):
            _close(_np(got[t][leaf]), _np(want[t][leaf]), 1e-5, leaf)


@pytest.mark.parametrize("strategy", ["naive", "hlora"])
def test_engine_new_masks_match_reference_engine(strategy):
    """Redistribution to other ranks, and a cohort of another size."""
    tree = _tree(61, layers=2)
    eta = np.array([1.0, 3.0, 2.0], np.float32)
    new = {t: np.stack([np.broadcast_to(
        (np.arange(8) < r).astype(np.float32), (2, 8)) for r in (3, 8, 1, 6)])
        for t in tree}
    got, spec = t_engine.AggregationEngine()(
        _ttree(tree), _t(eta), ALPHA, strategy=strategy,
        new_masks={t: _t(m) for t, m in new.items()})
    want, jspec = j_engine.AggregationEngine(use_pallas=False)(
        _jtree(tree), jnp.asarray(eta), ALPHA, strategy=strategy,
        new_masks=_jtree(new))
    for t in tree:
        np.testing.assert_array_equal(got[t]["mask"].numpy(), new[t])
        _close(spec[t].numpy(), np.asarray(jspec[t]), SPEC["rtol"])
    if strategy == "hlora":
        _assert_hlora_close(got, want, 1e-4)
    else:
        assert not spec["q"].any()
        for t in tree:
            for leaf in ("A", "B"):
                _close(got[t][leaf].numpy(), np.asarray(want[t][leaf]), 1e-5)


@pytest.mark.parametrize("method", ["exact", "randomized"])
def test_engine_dense_path_matches_reference_pallas_interpret(method):
    """The reference engine with ``use_pallas=True`` runs its ``recon_agg``
    Pallas kernel in interpret mode here; the port's engine runs the plain
    ``recon_agg`` on the CPU. Randomized: Σ r_k = 12 <= 16, exact."""
    rng = np.random.default_rng(71)
    tree = {"q": _stacked(rng, d_in=32, d_out=32, ranks=(6, 2, 4))}
    eta = np.array([1.0, 2.0, 1.0], np.float32)
    got, spec = t_engine.AggregationEngine()(_ttree(tree), _t(eta), ALPHA,
                                             method=method)
    want, jspec = j_engine.AggregationEngine(use_pallas=True)(
        _jtree(tree), jnp.asarray(eta), ALPHA, method=method)
    _assert_hlora_close(got, want, 1e-4, spec, jspec)


def test_engine_refuses_a_mesh_and_unknown_settings():
    with pytest.raises(NotImplementedError, match="mesh"):
        t_engine.AggregationEngine(mesh=object())
    with pytest.raises(ValueError, match="factored_impl"):
        t_engine.AggregationEngine(factored_impl="lu")
    tree = _ttree(_tree(0))
    with pytest.raises(ValueError, match="strategy"):
        t_engine.AggregationEngine()(tree, torch.ones(3), ALPHA,
                                     strategy="mean")
    with pytest.raises(ValueError, match="method"):
        t_engine.AggregationEngine()(tree, torch.ones(3), ALPHA,
                                     method="lanczos")
    assert t_engine.default_engine() is t_engine.default_engine()


# ---------------------------------------------------------------------------
# (5) rank_for_energy
# ---------------------------------------------------------------------------

def test_rank_for_energy_bit_identical():
    rng = np.random.default_rng(81)
    for shape in ((8,), (3, 8), (2, 3, 8)):
        s = np.sort(rng.random(shape).astype(np.float32))[..., ::-1].copy()
        for energy in (0.5, 0.9, 0.99):
            want = j_engine.rank_for_energy(s, energy, 2, 8)
            assert t_engine.rank_for_energy(s, energy, 2, 8) == want
            assert t_engine.rank_for_energy(_t(s), energy, 2, 8) == want


# ---------------------------------------------------------------------------
# (6) the slice as a whole: local training, then aggregation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained_cohorts():
    """Three clients (ranks 2/4/8) on roberta-reduced, from the reference's
    weights with trained-looking adapters, two local steps on each side;
    returns both sides' trained client-stacked adapter trees."""
    jcfg, tcfg = j_get_reduced("roberta-large"), get_reduced("roberta-large")
    jparams = j_model.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    for ad in jparams["lora"].values():
        ad["B"] = jnp.asarray(0.05 * rng.standard_normal(ad["B"].shape),
                              jnp.float32)
    jfrozen, jhead = j_client.split_head(jparams)
    jfactors, _ = j_client.split_adapters(jparams["lora"])
    tfrozen, _ = split_head(interop.params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    ranks, r_max, layers = (2, 4, 8), jcfg.lora.r_max, jcfg.num_layers
    masks = {t: np.stack([np.broadcast_to(
        (np.arange(r_max) < r).astype(np.float32), (layers, r_max))
        for r in ranks]) for t in jcfg.lora.targets}
    trainable = jax.tree.map(lambda a: np.stack([np.asarray(a)] * 3),
                             {"factors": jfactors, "head": jhead})
    tokens, labels = make_pair_classification("mrpc", 96, seed=3,
                                              vocab_size=tcfg.vocab_size)
    data = {k: np.stack([client_batches(tokens, labels, np.arange(96), 2, 8,
                                        seed=10 + c)[k] for c in range(3)])
            for k in ("tokens", "labels")}
    jtr, _ = j_client.make_cohort_train(jcfg, j_opt.adamw(1e-3))(
        jfrozen, jax.tree.map(jnp.asarray, trainable),
        jax.tree.map(jnp.asarray, masks), jax.tree.map(jnp.asarray, data))
    ttr, _ = make_cohort_train(tcfg, t_opt.adamw(1e-3), device="cpu")(
        tfrozen, interop.tree_from_numpy(trainable, "cpu"),
        interop.tree_from_numpy(masks, "cpu"),
        {k: _t(v) for k, v in data.items()})
    jtree = j_client.join_adapters(jtr["factors"], _jtree(masks))
    ttree = {t: {"A": f["A"], "B": f["B"], "mask": _t(masks[t])}
             for t, f in ttr["factors"].items()}
    return jtree, ttree


@pytest.mark.parametrize("method", ["factored", "exact"])
def test_slice_train_then_aggregate_matches_reference(trained_cohorts,
                                                      method):
    jtree, ttree = trained_cohorts
    eta = np.array([96.0, 40.0, 17.0], np.float32)
    got, spec = t_engine.AggregationEngine()(ttree, _t(eta), ALPHA,
                                             method=method)
    want, jspec = j_engine.AggregationEngine(use_pallas=False)(
        jtree, jnp.asarray(eta), ALPHA, method=method)
    for t in want:
        np.testing.assert_array_equal(got[t]["mask"].numpy(),
                                      np.asarray(want[t]["mask"]))
        _normwise(_updates(got[t]), _updates(want[t]), 1e-4, t)
        _close(spec[t].numpy(), np.asarray(jspec[t]), SPEC["rtol"], t)
    assert float(t_agg.aggregation_bias(ttree["q"], _t(eta), ALPHA)) > 0
