"""The port's cold-start fold-in against the JAX package's, on the same
numpy draws and the same noise: the reference's `fold_in(key)` draws its
noise with `_presample_noise`, and the port takes those bits as `z`.

Tolerance: rtol 1e-4, atol 1e-3, the half-sweep tolerance of
tests/test_torch_gibbs.py (fp32 statistics summed in another order, and
another Cholesky). The reference's fused engine runs as its own tests run
it on the CPU (the jnp path, interpret=None), never through interpret=True.
Without jit, the port's `trace_count()` counts plan-cache schema misses: a
"trace-flat" test of the reference is "miss-flat" here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest-xdist runs several workers on the same cores,
# and torch's default thread count each would oversubscribe them
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.data.sparse import SparseRatings as JRatings  # noqa: E402
from repro.serve import FoldInPlanCache as JCache  # noqa: E402
from repro.serve import PosteriorEnsemble as JEnsemble  # noqa: E402
from repro.serve import fold_in as jfold_in  # noqa: E402
from repro.serve.foldin import _presample_noise  # noqa: E402
from repro_torch.data import SparseRatings  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    FoldInPlanCache,
    PosteriorEnsemble,
    fold_in,
    fold_in_loop,
)
from repro_torch.serve import foldin as foldin_mod  # noqa: E402

S, M, N, K = 4, 50, 120, 8
TOL = dict(rtol=1e-4, atol=1e-3)
CPU = "cpu"


def _spd(k, rng):
    a = rng.normal(size=(k, k)).astype(np.float32) / np.sqrt(k)
    return a @ a.T + 2.0 * np.eye(k, dtype=np.float32)


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    return dict(
        u=rng.normal(size=(S, M, K)).astype(np.float32),
        v=rng.normal(size=(S, N, K)).astype(np.float32),
        hyper_u_mu=rng.normal(size=(S, K)).astype(np.float32) * 0.2,
        hyper_u_lam=np.stack([_spd(K, rng) for _ in range(S)]),
        hyper_v_mu=np.zeros((S, K), np.float32),
        hyper_v_lam=np.stack([np.eye(K, dtype=np.float32)] * S),
        global_mean=3.2, alpha=2.0, steps=list(range(S)),
    )


@pytest.fixture(scope="module")
def ens(arrays):
    return PosteriorEnsemble.from_arrays(**arrays, device=CPU)


@pytest.fixture(scope="module")
def jens(arrays):
    return JEnsemble.from_arrays(**arrays)


def _batch(degrees, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for u, d in enumerate(degrees):
        rows.extend([u] * int(d))
        cols.extend(rng.choice(N, int(d), replace=False).tolist())
        vals.extend(rng.normal(3.0, 1.0, int(d)).tolist())
    a = (np.asarray(rows, np.int32), np.asarray(cols, np.int32),
         np.asarray(vals, np.float32))
    return SparseRatings(*a, (len(degrees), N)), JRatings(*a, (len(degrees), N))


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("engine", ["einsum", "fused", "kernel"])
def test_fold_in_matches_reference_under_replayed_noise(ens, jens, engine, sample,
                                                        cached):
    ratings, jratings = _batch([3, 17, 40, 9, 1, 0, 110], seed=1)
    key = jax.random.PRNGKey(7) if sample else None
    z = (np.asarray(_presample_noise(jax.random.clone(key), S, 7, K))
         if sample else None)
    want = np.asarray(jfold_in(key, jratings, jens, sample=sample, engine=engine,
                               plan_cache=JCache() if cached else None))
    got = fold_in(None, ratings, ens, sample=sample, z=z, engine=engine,
                  plan_cache=FoldInPlanCache() if cached else None)
    assert got.shape == (S, 7, K) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("engine", ["fused", "kernel"])
def test_fused_matches_the_per_draw_loop(ens, engine):
    ratings, _ = _batch([5, 24, 11, 2], seed=2)
    z = torch.randn((S, 4, K), generator=torch.Generator().manual_seed(3))
    fused = fold_in(None, ratings, ens, z=z, engine=engine)
    loop = fold_in_loop(None, ratings, ens, z=z, engine=engine)
    np.testing.assert_allclose(fused.numpy(), loop.numpy(), **TOL)
    mean = fold_in(None, ratings, ens, sample=False, engine=engine)
    assert float((fused - mean).abs().max()) > 1e-3   # a draw, not the mean


def test_generator_draws_the_noise_and_sampling_needs_one(ens):
    ratings, _ = _batch([4, 6], seed=5)
    with pytest.raises(ValueError, match="torch.Generator or the noise z"):
        fold_in(None, ratings, ens)
    with pytest.raises(ValueError, match="torch.Generator or the noise z"):
        fold_in_loop(None, ratings, ens)
    a = fold_in(torch.Generator().manual_seed(9), ratings, ens)
    b = fold_in(torch.Generator().manual_seed(9), ratings, ens)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="z must be"):
        fold_in(None, ratings, ens, z=np.zeros((S, 3, K), np.float32))


def test_zero_rating_batch_gives_the_prior_mean(ens, jens):
    empty = SparseRatings(np.zeros(0, np.int32), np.zeros(0, np.int32),
                          np.zeros(0, np.float32), (3, N))
    for cache in (None, FoldInPlanCache()):
        mean = fold_in(None, empty, ens, sample=False, plan_cache=cache)
        assert mean.shape == (S, 3, K)
        want = np.broadcast_to(np.asarray(jens.hyper_u_mu)[:, None], (S, 3, K))
        np.testing.assert_allclose(mean.numpy(), want, rtol=1e-4, atol=1e-4)


def test_plan_cache_padding_is_exact(ens):
    ratings, _ = _batch([3, 17, 40, 9, 1], seed=4)
    z = torch.randn((S, 5, K), generator=torch.Generator().manual_seed(1))
    for engine in ("einsum", "fused", "kernel"):
        for kw in (dict(sample=False), dict(z=z)):
            exact = fold_in(None, ratings, ens, engine=engine, **kw)
            cached = fold_in(None, ratings, ens, engine=engine,
                             plan_cache=FoldInPlanCache(), **kw)
            np.testing.assert_allclose(cached.numpy(), exact.numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_same_profile_batches_miss_no_schema(ens):
    cache = FoldInPlanCache()
    degrees = [6, 28, 45, 10]
    fold_in(None, _batch(degrees, seed=10)[0], ens, sample=False, plan_cache=cache)
    assert cache.stats() == {"hits": 0, "misses": 1, "entries": 1}
    misses = foldin_mod.trace_count()
    for i in range(4):  # fresh items and values, the same rating-count profile
        fold_in(None, _batch(degrees, seed=20 + i)[0], ens, sample=False,
                plan_cache=cache)
    assert foldin_mod.trace_count() == misses
    assert cache.stats() == {"hits": 4, "misses": 1, "entries": 1}
    # a profile within the same power-of-two bands hits; a new family misses
    fold_in(None, _batch([7, 25, 44, 35], seed=31)[0], ens, sample=False,
            plan_cache=cache)
    assert cache.hits == 5
    fold_in(None, _batch([100, 110], seed=32)[0], ens, sample=False,
            plan_cache=cache)
    assert cache.misses == 2


def test_schemas_and_balanced_ladder_match_reference():
    ref_degrees = np.repeat([2, 3, 5, 11, 21], 40)
    ours, theirs = FoldInPlanCache.balanced(ref_degrees), JCache.balanced(ref_degrees)
    assert ours.widths == tuple(theirs.widths)
    assert any(w & (w - 1) for w in ours.widths)  # not only powers of two
    profile = ((8, 3, 3), (32, 17, 12), (128, 1, 1))
    assert ours.schema(profile, 5, N) == theirs.schema(profile, 5, N)


def test_balanced_cache_is_exact_and_miss_flat(ens):
    cache = FoldInPlanCache.balanced(np.repeat([2, 3, 5, 11, 21], 40))
    degrees = [2, 5, 11, 21]
    ratings = _batch(degrees, seed=40)[0]
    exact = fold_in(None, ratings, ens, sample=False)
    got = fold_in(None, ratings, ens, sample=False, plan_cache=cache)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-4, atol=1e-4)
    misses = foldin_mod.trace_count()
    for i in range(3):
        fold_in(None, _batch(degrees, seed=41 + i)[0], ens, sample=False,
                plan_cache=cache)
    assert foldin_mod.trace_count() == misses and cache.stats()["misses"] == 1


def test_ensemble_fold_in_helpers_match_reference(ens, jens):
    """score_factors and user_scoring_rows, on the same per-draw factors."""
    u_draws = np.random.default_rng(3).normal(size=(S, 5, K)).astype(np.float32)
    items = np.array([0, 7, 119, 5, 5])
    for a, b in zip(ens.score_factors(torch.as_tensor(u_draws), items),
                    jens.score_factors(jax.numpy.asarray(u_draws), items)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        ens.user_scoring_rows(torch.as_tensor(u_draws)).numpy(),
        np.asarray(jens.user_scoring_rows(jax.numpy.asarray(u_draws))))


def test_clone_of_a_rating_profile_predicts_its_ratings(arrays):
    """Ratings a user with factor w gives (draws sharing one V): folded in
    with sample=False, the posterior mean predicts them back within 0.25,
    the tolerance the chip run holds ChEMBL clones to; a fold-in that skips
    the global-mean shift misses by the mean."""
    rng = np.random.default_rng(8)
    shared = dict(arrays, v=np.repeat(arrays["v"][:1], S, axis=0))
    ens = PosteriorEnsemble.from_arrays(**shared, device=CPU)
    items = rng.choice(N, 60, replace=False)
    w = rng.normal(size=K).astype(np.float32) * 0.5
    vals = shared["v"][0, items] @ w + ens.global_mean
    clone = SparseRatings(np.zeros(60, np.int32), items.astype(np.int32),
                          vals.astype(np.float32), (1, N))
    for engine in ("fused", "kernel"):
        u = fold_in(None, clone, ens, sample=False, engine=engine)
        pred, _ = ens.score_factors(u.expand(S, 60, K), items)
        assert float((pred - torch.as_tensor(vals)).abs().max()) < 0.25
    unshifted = SparseRatings(clone.rows, clone.cols, clone.vals - ens.global_mean,
                              clone.shape)
    u = fold_in(None, unshifted, ens, sample=False)
    pred, _ = ens.score_factors(u.expand(S, 60, K), items)
    assert float((pred - torch.as_tensor(vals)).abs().max()) > 0.25
