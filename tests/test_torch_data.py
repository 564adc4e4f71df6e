"""The port's numpy layer against the reference: datasets, splits and
bucket plans must be equal array for array (the same numpy code on the same
seeds), since sweep parity rests on plan parity."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest-xdist runs several workers on the same cores,
# and torch's default thread count each would oversubscribe them
torch.set_num_threads(1)

from repro.core import buckets as jb  # noqa: E402
from repro.data import datasets as jd  # noqa: E402
from repro.data import sparse as js  # noqa: E402
from repro_torch.core import buckets as tb  # noqa: E402
from repro_torch.data import datasets as td  # noqa: E402
from repro_torch.data import sparse as ts  # noqa: E402


def _same_ratings(a, b):
    assert a.shape == b.shape
    for name in ("rows", "cols", "vals"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("make,scale", [
    ("chembl_like", 0.01), ("movielens_like", 0.005),
])
def test_datasets_and_split_bit_equal(make, scale):
    rj, uj, vj = getattr(jd, make)(scale, seed=3)
    rt, ut, vt = getattr(td, make)(scale, seed=3)
    _same_ratings(rj, rt)
    np.testing.assert_array_equal(uj, ut)
    np.testing.assert_array_equal(vj, vt)
    for sj, st in zip(jd.train_test_split(rj, 0.1, seed=1),
                      td.train_test_split(rt, 0.1, seed=1)):
        _same_ratings(sj, st)


def test_synthetic_lowrank_and_csr_bit_equal():
    kw = dict(k_true=4, nnz=900, noise=0.2, seed=5, clip=(-1.0, 1.0))
    rj, _, _ = jd.synthetic_lowrank(60, 40, **kw)
    rt, _, _ = td.synthetic_lowrank(60, 40, **kw)
    _same_ratings(rj, rt)
    for x, y in zip(js.csr_from_coo(rj.rows, rj.cols, rj.vals, 60),
                    ts.csr_from_coo(rt.rows, rt.cols, rt.vals, 60)):
        np.testing.assert_array_equal(x, y)
    _same_ratings(rj.centered().transpose(), rt.centered().transpose())


def _same_plan(pj, pt):
    assert (pj.n_items, pj.n_counterparts, pj.nnz, pj.padded, pj.widths) == (
        pt.n_items, pt.n_counterparts, pt.nnz, pt.padded, pt.widths)
    assert pj.stats() == pt.stats()
    np.testing.assert_array_equal(pj.empty_items, pt.empty_items)
    assert len(pj.buckets) == len(pt.buckets)
    for bj, bt in zip(pj.buckets, pt.buckets):
        assert (bj.width, bj.n_segments) == (bt.width, bt.n_segments)
        for name in ("indices", "values", "mask", "item_ids", "seg_ids",
                     "seg_item_ids"):
            x, y = getattr(bj, name), getattr(bt, name)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("make,scale", [
    ("chembl_like", 0.02), ("movielens_like", 0.005),
])
@pytest.mark.parametrize("widths", ["balanced", (8, 32, 128, 512), (4, 16)])
def test_plans_array_equal(make, scale, widths):
    ratings, _, _ = getattr(jd, make)(scale, seed=0)
    c = ratings.centered()
    for r in (c, c.transpose()):
        ptr, idx, val = js.csr_from_coo(r.rows, r.cols, r.vals, r.shape[0])
        pj = jb.plan_buckets(ptr, idx, val, r.shape[0], r.shape[1], widths)
        pt = tb.plan_buckets(ptr, idx, val, r.shape[0], r.shape[1], widths)
        _same_plan(pj, pt)


@pytest.mark.parametrize("kwargs", [
    dict(max_buckets=8), dict(max_buckets=3, lane=8), dict(max_buckets=1),
    dict(max_buckets=2, max_width=64, per_rating=0.1),
])
def test_balanced_widths_equal(kwargs):
    rng = np.random.default_rng(11)
    degrees = np.minimum(rng.zipf(1.4, 400), 3000)
    assert jb.balanced_widths(degrees, **kwargs) == tb.balanced_widths(
        degrees, **kwargs)
    assert jb.resolve_widths("balanced", degrees) == tb.resolve_widths(
        "balanced", degrees)
    np.testing.assert_array_equal(jb.workload_model(degrees),
                                  tb.workload_model(degrees))


def test_balanced_widths_reproduces_reference_overshoot():
    """Known divergence kept on purpose (ROADMAP queue 3): with an oversize
    degree, max_buckets=1 returns two widths in the reference; the port
    returns the same ladder, because plan parity matters more."""
    rng = np.random.default_rng(0)
    degrees = np.minimum((rng.zipf(1.25, 5)).astype(np.int64), 10_000)
    degrees[0] = 700  # above max_width=512
    ref = jb.balanced_widths(degrees, max_buckets=1)
    assert tb.balanced_widths(degrees, max_buckets=1) == ref
    assert len(ref) == 2 and ref[-1] == 512


def test_pad_bucket_equal():
    ratings, _, _ = jd.movielens_like(0.005, seed=1)
    ptr, idx, val = js.csr_from_coo(ratings.rows, ratings.cols, ratings.vals,
                                    ratings.shape[0])
    bj = jb.plan_buckets(ptr, idx, val, ratings.shape[0], ratings.shape[1]).buckets[0]
    bt = tb.plan_buckets(ptr, idx, val, ratings.shape[0], ratings.shape[1]).buckets[0]
    pj = jb.pad_bucket(bj, bj.rows + 5, bj.n_segments + 3)
    pt = tb.pad_bucket(bt, bt.rows + 5, bt.n_segments + 3)
    for name in ("indices", "values", "mask", "item_ids", "seg_ids", "seg_item_ids"):
        np.testing.assert_array_equal(getattr(pj, name), getattr(pt, name))
    with pytest.raises(ValueError):
        tb.pad_bucket(bt, bt.rows - 1, bt.n_segments)
