"""The port's retention and serving layers against the JAX package: draws
written by either SampleStore load in the other, and the ensemble and the
top-N tier give the same answers on the same draws.

Tolerances, and why:
  * stored arrays: equal bit for bit (the same .npy files).
  * ensemble mean and variance: rtol 1e-5, atol 1e-5 (fp32 dot products of
    K = 8 terms summed in another order).
  * top-N: the selected indices are equal; values rtol 1e-5, atol 1e-5
    (the scores are summed in another order than XLA's gemm).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest-xdist runs several workers on the same cores,
# and torch's default thread count each would oversubscribe them
torch.set_num_threads(1)

from repro.checkpoint import SampleStore as JSampleStore  # noqa: E402
from repro.data import movielens_like  # noqa: E402
from repro.serve import PosteriorEnsemble as JEnsemble  # noqa: E402
from repro.serve import TopNRecommender as JTopN  # noqa: E402
from repro_torch.checkpoint import SAMPLE_KEYS, SampleStore  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ClusterCoordinator,
    PosteriorEnsemble,
    SeenIndex,
    TopNRecommender,
)
from repro_torch.serve.cluster import _merge_topk, shard_bounds  # noqa: E402

CPU = "cpu"


def _draw(rng, m, n, k, offset=0.0):
    return {
        "u": rng.normal(size=(m, k)).astype(np.float32),
        "v": (rng.normal(size=(n, k)) + offset).astype(np.float32),
        "hyper_u_mu": rng.normal(size=k).astype(np.float32),
        "hyper_u_lam": np.eye(k, dtype=np.float32),
        "hyper_v_mu": rng.normal(size=k).astype(np.float32),
        "hyper_v_lam": 2 * np.eye(k, dtype=np.float32),
        "global_mean": np.asarray(3.25, np.float32),
        "alpha": np.asarray(2.0, np.float32),
    }


@pytest.fixture
def draws():
    rng = np.random.default_rng(0)
    return [_draw(rng, 40, 300, 8, offset=0.1 * i) for i in range(3)]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_sample_store_draws_load_in_the_other_package(tmp_path, draws, writer):
    make_w, make_r = (SampleStore, JSampleStore) if writer == "torch" else (
        JSampleStore, SampleStore)
    w = make_w(tmp_path, keep=2)
    for step, d in zip((5, 6, 7), draws):
        w.retain(step, d)
    w.wait()
    r = make_r(tmp_path)
    assert r.steps() == [6, 7] and r.epoch() == 7   # keep-last-2 pruned step 5
    for got, want in zip(r.load_all(), draws[1:]):
        for key in SAMPLE_KEYS:
            np.testing.assert_array_equal(np.asarray(getattr(got, key)), want[key])


def test_ensemble_matches_reference(tmp_path, draws):
    store = SampleStore(tmp_path)
    for step, d in enumerate(draws):
        store.retain(step, d)
    store.wait()
    et = PosteriorEnsemble.load(tmp_path, device=CPU)
    ej = JEnsemble.load(tmp_path)
    assert et.shape_key() == ej.shape_key() and et.epoch == ej.epoch == 2
    users = np.array([0, 3, 39, 7])
    items = np.array([1, 299, 5, 5])
    for a, b in zip(et.score(users, items), ej.score(users, items)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(et.mean_stderr(users, items).numpy(),
                               np.asarray(ej.mean_stderr(users, items)),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(et.scoring_matrices(), ej.scoring_matrices()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n_shards", [1, 3])
def test_recommend_with_exclusion_matches_reference(tmp_path, draws, n_shards):
    store = SampleStore(tmp_path)
    for step, d in enumerate(draws):
        store.retain(step, d)
    store.wait()
    seen_ratings = movielens_like(0.002, seed=2)[0]
    keep = (seen_ratings.rows < 40) & (seen_ratings.cols < 300)
    seen_ratings = type(seen_ratings)(
        seen_ratings.rows[keep], seen_ratings.cols[keep], seen_ratings.vals[keep],
        (40, 300))
    users = np.arange(40)
    jv, ji = JTopN(JEnsemble.load(tmp_path), n_shards=n_shards).recommend(
        users, 12, seen=seen_ratings)
    rec = TopNRecommender(PosteriorEnsemble.load(tmp_path, device=CPU),
                          n_shards=n_shards, device=CPU)
    tv, ti = rec.recommend(users, 12, seen=SeenIndex(seen_ratings))
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-5, atol=1e-5)
    assert rec.n_shards == n_shards


def test_sharded_merge_keeps_lowest_index_on_ties(draws):
    """Planted duplicate items across shard bounds: the shards' merge gives
    what one unsharded top-k gives, ties to the lowest index."""
    d = dict(draws[0])
    d["v"] = d["v"].copy()
    for dup in (50, 120, 299):
        d["v"][dup] = d["v"][10]
    ens = PosteriorEnsemble([_retained(0, d)], device=CPU)
    one = ClusterCoordinator(ens, n_hosts=1, device=CPU)
    four = ClusterCoordinator(ens, n_hosts=4, device=CPU)
    rows = ens.scoring_matrices()[0][:9]
    v1, i1 = one.recommend_rows(rows, 20)
    v4, i4 = four.recommend_rows(rows, 20)
    np.testing.assert_array_equal(i1, i4)
    np.testing.assert_array_equal(v1, v4)
    np.testing.assert_array_equal(shard_bounds(300, 4), [0, 75, 150, 225, 300])
    vals = torch.tensor([[1.0, 2.0, 2.0, 0.5]])
    idx = torch.tensor([[3, 7, 9, 1]], dtype=torch.int32)
    mv, mi = _merge_topk(vals, idx, 2)
    assert mi.tolist() == [[7, 9]] and mv.tolist() == [[2.0, 2.0]]


def test_rebind_keeps_layout_and_rejects_new_shapes(draws):
    ens = PosteriorEnsemble([_retained(1, draws[0])], device=CPU)
    rec = TopNRecommender(ens, n_shards=2, device=CPU)
    nxt = rec.rebind(PosteriorEnsemble([_retained(2, draws[1])], device=CPU))
    assert isinstance(nxt, TopNRecommender)
    assert nxt.n_shards == 2 and nxt.epoch == 2 and rec.epoch == 1
    np.testing.assert_array_equal(nxt.shard_bounds, rec.shard_bounds)
    small = dict(draws[2], v=draws[2]["v"][:100])
    with pytest.raises(ValueError):
        rec.rebind(PosteriorEnsemble([_retained(3, small)], device=CPU))


def test_state_from_sample_carries_a_retained_draw(draws):
    from repro_torch.core import state_from_sample

    st = state_from_sample(draws[1], step=5, n_test=3, device=CPU)
    np.testing.assert_array_equal(st.u.numpy(), draws[1]["u"])
    np.testing.assert_array_equal(st.v.numpy(), draws[1]["v"])
    np.testing.assert_array_equal(st.hyper_v.lam.numpy(), draws[1]["hyper_v_lam"])
    np.testing.assert_array_equal(st.hyper_u.mu.numpy(), draws[1]["hyper_u_mu"])
    assert st.step == 5 and st.pred_count == 0 and st.pred_sum.tolist() == [0.0] * 3


def test_seen_index_rejects_shrinking():
    ratings = movielens_like(0.002, seed=2)[0]
    idx = SeenIndex(ratings)
    big = idx.resized((ratings.shape[0] + 5, ratings.shape[1] + 5))
    assert big[ratings.shape[0] + 2].size == 0
    np.testing.assert_array_equal(big[0], idx[0])
    with pytest.raises(ValueError):
        SeenIndex(ratings, shape=(ratings.shape[0] - 1, ratings.shape[1]))


def _retained(step, d):
    from repro_torch.checkpoint import RetainedSample

    return RetainedSample(step=step, **{k: d[k] for k in SAMPLE_KEYS
                                        if k not in ("global_mean", "alpha")},
                          global_mean=float(d["global_mean"]),
                          alpha=float(d["alpha"]))


# ---------------------------------------------------------------------------
# the serving tier against the reference's
# ---------------------------------------------------------------------------
def _epoch_coded(step, m=40, n=57, k=4):
    u = np.full((m, k), 1.0 / k, np.float32)
    v = np.zeros((n, k), np.float32)
    v[step % n] = float(step)
    rng = np.random.default_rng(step)
    return dict(_draw(rng, m, n, k), u=u, v=v)


@pytest.fixture(scope="module")
def tier_draws():
    rng = np.random.default_rng(5)
    return [(s, _draw(rng, 40, 57, 4, offset=0.05 * s)) for s in (1, 2, 3)]


@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_tier_matches_reference_tier_and_single_host(tier_draws, n_hosts, replicas):
    """The same draws through the port's tier and the JAX package's tier and
    single host: warm users with exclusions, explicit rows with a fetch
    hint, and fold-in factors give the same indices, scores within 1e-5;
    the port's tier equals its own single host bit for bit."""
    from repro.checkpoint import as_retained_sample as jretained
    from repro.serve import ClusterCoordinator as JCluster
    from repro_torch.checkpoint import as_retained_sample

    ens = PosteriorEnsemble([as_retained_sample(s, d) for s, d in tier_draws],
                            device=CPU)
    jens = JEnsemble([jretained(s, d) for s, d in tier_draws])
    ours = ClusterCoordinator(ens, n_hosts=n_hosts, replicas=replicas, device=CPU)
    single = TopNRecommender(ens, device=CPU)
    theirs = [JCluster(jens, n_hosts=n_hosts, replicas=replicas), JTopN(jens)]
    users = np.arange(12, dtype=np.int32)
    exclude = [np.arange(r, r + 4, dtype=np.int32) for r in range(12)]
    rows = single.u_flat[users]
    u_draws = np.random.default_rng(0).normal(size=(3, 5, 4)).astype(np.float32)
    calls = [
        lambda r, t: r.recommend(users, 9),
        lambda r, t: r.recommend_rows(rows if t else jax_rows, 6, exclude=exclude,
                                      fetch_hint=16),
        lambda r, t: r.recommend_factors(torch.as_tensor(u_draws) if t
                                         else u_draws, 4),
    ]
    jax_rows = np.asarray(theirs[1].u_flat)[users]
    for call in calls:
        v, i = call(ours, True)
        sv, si = call(single, True)
        np.testing.assert_array_equal(i, si)
        np.testing.assert_array_equal(v, sv)
        for ref in theirs:
            jv, ji = call(ref, False)
            np.testing.assert_array_equal(i, np.asarray(ji))
            np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-5, atol=1e-5)
    assert ours.n_shards == max(1, -(-n_hosts // replicas))


def test_partial_staging_holds_the_epoch_and_staggered_hosts_skip_ahead():
    from repro_torch.checkpoint import as_retained_sample

    def ens(step):
        return PosteriorEnsemble([as_retained_sample(step, _epoch_coded(step))],
                                 device=CPU)

    cluster = ClusterCoordinator(ens(1), n_hosts=3, device=CPU)
    nxt = ens(2)
    for host in cluster.hosts[:-1]:
        with cluster._lock:
            host.staged = host.stage(nxt)
            assert cluster._commit_locked(None) is False
        assert cluster.epoch == 1
    with cluster._lock:
        cluster.hosts[-1].staged = cluster.hosts[-1].stage(nxt)
        assert cluster._commit_locked(None) is True
    assert cluster.epoch == 2 and all(h.staged is None for h in cluster.hosts)
    # host a staged 3, host b jumped to 4: hold, then both on 4 commit it
    two = ClusterCoordinator(ens(1), n_hosts=2, device=CPU)
    a, b = two.hosts
    with two._lock:
        a.staged, b.staged = a.stage(ens(3)), b.stage(ens(4))
        assert two._commit_locked(None) is False
        a.staged = a.stage(ens(4))
        assert two._commit_locked(None) is True
    assert two.epoch == 4 and two.commits == 1   # epoch 3 was never served
    vals, idx = two.recommend(np.arange(3, dtype=np.int32), 1)
    assert float(vals[0][0]) == 4.0 + 3.25 and idx[0][0] == 4   # global mean 3.25


def test_colocated_hosts_share_one_u_table_and_routed_hosts_stage_their_own(draws):
    ens = PosteriorEnsemble([_retained(1, draws[0])], device=CPU)
    rec = TopNRecommender(ens, n_shards=3, device=CPU)
    assert not rec.routed
    assert len({h.live.u_replica.data_ptr() for h in rec.hosts}) == 1
    assert [v.shape[0] for v in rec.v_shards] == [100, 100, 100]
    np.testing.assert_array_equal(rec.shard_offsets, [0, 100, 200])
    tier = ClusterCoordinator(ens, n_hosts=2, device=CPU)
    assert tier.routed
    nxt = PosteriorEnsemble([_retained(2, draws[1])], device=CPU)
    staged = [h.stage(nxt) for h in tier.hosts]
    assert staged[0].u_replica.data_ptr() != staged[1].u_replica.data_ptr()
    assert torch.equal(staged[0].u_replica, staged[1].u_replica)
