"""The port's ``bgmv`` op on the CPU: the out-of-range slot rule against the
reference, the refusal of an empty slot table, and the CUDA kernel's split
planner (``plan_bgmv``) and launch flags.

The CUDA kernel itself runs only on the GPU: ``chip_smoke.py`` holds it to
``bgmv_plain`` there, on the same out-of-range slots.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro_torch.kernels import bgmv as bgmv_mod
from repro_torch.kernels import ops

# float32 on both sides; the products are summed in another order, so
# results agree to a few ulp of O(1) values.
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# the slot rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slot", [-4, -3, -2, -1, 3, 8])
def test_out_of_range_slot_follows_the_reference(slot):
    """S = 3: -S-1, -S, -2, -1, S, S+5 beside in-range rows. The
    reference's Pallas kernel (interpret mode) and its gather both add S
    to a negative slot and clamp to [0, S - 1]; float32 reordering (TOL)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 48), dtype=np.float32)
    a = (rng.standard_normal((3, 48, 8), dtype=np.float32)
         / np.sqrt(48)).astype(np.float32)
    b = rng.standard_normal((3, 8, 40), dtype=np.float32)
    idx = np.array([0, slot, 2, slot], np.int32)
    got = ops.bgmv(_t(x), _t(a), _t(b), _t(idx)).numpy()
    ja, jb, ji = jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx)
    want_kernel = np.asarray(jops.bgmv(jnp.asarray(x), ja, jb, ji,
                                       interpret=True))
    want_gather = np.asarray(jnp.einsum("bd,bdr,bro->bo", jnp.asarray(x),
                                        ja[ji], jb[ji]))
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_gather, **TOL)
    rule = min(max(slot + 3 if slot < 0 else slot, 0), 2)
    np.testing.assert_allclose(got[1], x[1] @ a[rule] @ b[rule], **TOL)


def test_slot_index_rule():
    idx = torch.tensor([-5, -4, -3, -2, -1, 0, 2, 3, 8], dtype=torch.int32)
    assert bgmv_mod.slot_index(idx, 3).tolist() == [0, 0, 0, 1, 2, 0, 2, 2,
                                                    2]


@pytest.mark.parametrize("bsz", [2, 0])
def test_op_refuses_an_empty_slot_table(bsz):
    with pytest.raises(ValueError, match="no slot"):
        ops.bgmv(torch.randn(bsz, 8), torch.randn(0, 8, 4),
                 torch.randn(0, 4, 5), torch.zeros(bsz, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the split planner
# ---------------------------------------------------------------------------

# blocks an H100 holds at once in clusters of 1..8 (the runtime's
# cudaOccupancyMaxActiveClusters x size for a kernel of two blocks an SM)
H100_LIKE = (264, 264, 237, 248, 235, 234, 224, 240)


def _row_bounds(plan):
    """Each block's rows [lo, hi) of d_in, in slab order, as the kernel
    takes them from the plan."""
    per = plan.rows_per_split
    return [(c * per, min(plan.d_in, (c + 1) * per))
            for c in range(plan.n_splits)]


def _col_bounds(plan):
    """Each block's columns [lo, hi) of d_out (empty past d_out)."""
    per = plan.cols_per_split
    return [(min(plan.d_out, c * per), min(plan.d_out, (c + 1) * per))
            for c in range(plan.n_splits)]


@settings(deadline=None, max_examples=300)
@given(batch=st.integers(0, 64), d_in=st.integers(0, 9000),
       d_out=st.integers(0, 9000), r=st.integers(1, 64),
       element_size=st.sampled_from([2, 4]),
       slots=st.lists(st.integers(0, 600), min_size=8, max_size=8)
       .filter(lambda s: s[0] >= 1))
def test_plan_bgmv_covers_and_fits(batch, d_in, d_out, r, element_size,
                                   slots):
    """The slabs cover d_in exactly once, in order, none empty, each a
    whole number of SLAB rows; the column shares cover d_out once; the
    cluster size is one the slots hold (slots[C - 1] >= C) and at most
    MAX_SPLITS; no other cut into whole slabs costs less."""
    plan = bgmv_mod.plan_bgmv(batch, d_in, r, d_out, slots, element_size)
    assert 1 <= plan.n_splits <= bgmv_mod.MAX_SPLITS
    assert plan.n_splits == 1 or slots[plan.n_splits - 1] >= plan.n_splits
    assert plan.rows_per_split % bgmv_mod.SLAB == 0
    assert plan.cols_per_split % bgmv_mod.SLAB == 0
    rows = _row_bounds(plan)
    assert rows[0][0] == 0 and rows[-1][1] == d_in
    assert all(lo < hi for lo, hi in rows) or d_in == 0
    assert all(rows[i][1] == rows[i + 1][0] for i in range(len(rows) - 1))
    covered = np.zeros(d_in, np.int64)
    for lo, hi in rows:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    cols = _col_bounds(plan)
    assert cols[0][0] == 0 and cols[-1][1] == d_out
    assert all(cols[i][1] == cols[i + 1][0] for i in range(len(cols) - 1))
    cost = bgmv_mod.bgmv_cost(plan, slots, element_size)
    for n in range(1, bgmv_mod.MAX_SPLITS + 1):
        other = bgmv_mod.bgmv_plan(batch, d_in, r, d_out, n)
        assert bgmv_mod.bgmv_cost(other, slots, element_size) >= cost


@pytest.mark.parametrize("bad", [
    dict(batch=8.0), dict(d_in=np.int64(2048)), dict(r=True),
    dict(d_out=torch.tensor(2048)), dict(slots=[264] * 7),
    dict(slots=[264.0] * 8), dict(element_size=4.0)])
def test_plan_bgmv_takes_ints_only(bad):
    kw = dict(batch=8, d_in=2048, r=8, d_out=2048, slots=H100_LIKE,
              element_size=4)
    kw.update(bad)
    with pytest.raises(TypeError):
        bgmv_mod.plan_bgmv(**kw)


@pytest.mark.parametrize("bad", [
    dict(r=0), dict(r=65), dict(element_size=8), dict(d_in=-1),
    dict(slots=(0,) * 8)])
def test_plan_bgmv_refuses_what_the_kernel_cannot_run(bad):
    kw = dict(batch=8, d_in=2048, r=8, d_out=2048, slots=H100_LIKE,
              element_size=4)
    kw.update(bad)
    with pytest.raises(ValueError):
        bgmv_mod.plan_bgmv(**kw)


@settings(deadline=None, max_examples=200)
@given(cols=st.integers(1, 1200).map(lambda n: 8 * n), r=st.integers(1, 64),
       element_size=st.sampled_from([2, 4]), vec_b=st.booleans())
def test_column_lanes_fit_the_block(cols, r, element_size, vec_b):
    """Phase two's lanes a column vector: a power of two within one warp
    (they sum by shuffles); enough for one batch of B_ROWS rank rows a
    lane (16-byte loads of B) or one rank row a lane (element loads)
    unless the warp or the block's column vectors leave no room for more
    lanes; never more lanes than that."""
    p = bgmv_mod.column_lanes(cols, r, element_size, vec_b)
    vecs = cols // (16 // element_size)
    rows = bgmv_mod.B_ROWS if vec_b else 1
    assert p & (p - 1) == 0 and p <= 32
    assert p == 1 or vecs * p <= bgmv_mod.THREADS
    assert p * rows >= r or p == 32 or vecs * p * 2 > bgmv_mod.THREADS
    assert p == 1 or (p // 2) * rows < r


def test_trips_count_passes_merge_and_batches():
    """float32, R 8: a pass holds 1024 rows (128 a step, LOADS steps), so
    one split of 2048 rows makes two passes and four splits one pass and a
    merge; at R 64 (16 rows a step) and 2048 columns in 8 splits, P = 4
    lanes a column vector take 16 rank rows each, two batches of B_ROWS;
    at 256 columns, P = 8 take one batch."""
    trips = bgmv_mod.bgmv_trips
    plan = bgmv_mod.bgmv_plan
    assert trips(plan(8, 2048, 8, 256, 1), 4) == 2
    assert trips(plan(8, 2048, 8, 256, 4), 4) == 2
    assert trips(plan(8, 2048, 8, 256, 1), 2) == 1
    assert bgmv_mod.column_lanes(256, 64, 4) == 4
    assert trips(plan(8, 2048, 64, 2048, 8), 4) == 2 + 1 + 1
    assert bgmv_mod.column_lanes(32, 64, 4) == 8
    assert trips(plan(8, 2048, 64, 256, 8), 4) == 2 + 1


def test_vector_flags():
    f = bgmv_mod.vector_flags
    assert f(4, 2048, 8, 2048, (0, 16, 32, 48)) == 7
    assert f(4, 2000, 13, 1000, (0, 16, 32, 48)) == 1 | 4
    assert f(4, 2001, 8, 1001, (0, 16, 32, 48)) == 2
    assert f(2, 2048, 8, 2048, (4, 16, 32, 48)) == 2 | 4
    assert f(2, 2048, 4, 2048, (0, 16, 32, 8)) == 1
