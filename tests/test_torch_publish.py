"""The port's publication channel, the trainer's publish path and the
request frontend against the JAX package, on the same numpy draws.

Tolerances: channel snapshots, stored and published arrays, and served
item indices are equal exactly; served scores rtol 1e-5, atol 1e-5 (the
top-N tolerance of tests/test_torch_serve.py). No test waits on the wall
clock: threads are synchronised by Events and condition waits with
generous timeouts that fail loudly.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest-xdist runs several workers on the same cores,
# and torch's default thread count each would oversubscribe them
torch.set_num_threads(1)

from repro.serve import PublicationChannel as JChannel  # noqa: E402
from repro.serve import RecommendFrontend as JFrontend  # noqa: E402
from repro_torch.checkpoint import SampleStore, as_retained_sample  # noqa: E402
from repro_torch.core import GibbsSampler  # noqa: E402
from repro_torch.data import (  # noqa: E402
    SparseRatings,
    synthetic_lowrank,
    train_test_split,
)
from repro_torch.serve import (  # noqa: E402
    PosteriorEnsemble,
    PublicationChannel,
    RecommendFrontend,
    TopNRecommender,
    fold_in,
)

M, N, K = 24, 16, 4
CPU = "cpu"
WAIT = 20.0  # generous bound for condition waits; normal paths take ms


def make_sample(step: int, *, u=None, v=None) -> dict:
    rng = np.random.default_rng(step)
    return {
        "u": rng.normal(size=(M, K)).astype(np.float32) if u is None else u,
        "v": rng.normal(size=(N, K)).astype(np.float32) if v is None else v,
        "hyper_u_mu": np.zeros(K, np.float32),
        "hyper_u_lam": np.eye(K, dtype=np.float32),
        "hyper_v_mu": np.zeros(K, np.float32),
        "hyper_v_lam": np.eye(K, dtype=np.float32),
        "global_mean": np.float32(0.0),
        "alpha": np.float32(2.0),
    }


def epoch_coded_sample(step: int) -> dict:
    """Top-1 score == step on item step % N: a torn swap scores wrong."""
    u = np.full((M, K), 1.0 / K, np.float32)
    v = np.zeros((N, K), np.float32)
    v[step % N] = float(step)
    return make_sample(step, u=u, v=v)


def _state(ch):
    snap = ch.snapshot()
    return None if snap is None else (snap.epoch, snap.seq, [d.step for d in snap.draws])


# ---------------------------------------------------------------------------
# channel semantics, step for step against the reference
# ---------------------------------------------------------------------------
def test_channel_snapshots_match_reference():
    """Out-of-order, duplicate and too-old publishes: the same accept/drop
    answers and the same (epoch, seq, window steps) after every publish."""
    ours, theirs = PublicationChannel(window=3), JChannel(window=3)
    assert _state(ours) is None and ours.epoch is None and ours.seq == 0
    for step in (10, 12, 11, 14, 12, 9, 15, 13, 13, 20, 1):
        assert ours.publish(step, make_sample(step)) == theirs.publish(
            step, make_sample(step)), step
        assert _state(ours) == _state(theirs), step
        assert ours.epoch == theirs.epoch and ours.seq == theirs.seq
    assert _state(ours) == (20, 7, [14, 15, 20])
    assert ours.publish_time(20) is not None and ours.publish_time(10) is None


def test_channel_wait_and_close():
    ch = PublicationChannel(window=2)
    assert ch.wait(timeout=0.01) is None
    got, waiting = [], threading.Event()

    def waiter():
        waiting.set()
        got.append(ch.wait(timeout=WAIT))

    t = threading.Thread(target=waiter)
    t.start()
    assert waiting.wait(WAIT)
    ch.publish(1, make_sample(1))
    t.join(timeout=WAIT)
    assert not t.is_alive() and got and got[0].epoch == 1
    assert ch.wait(newer_than=1, timeout=0.01) is None   # nothing newer yet
    ch.close()
    assert ch.closed
    assert ch.wait(newer_than=1, timeout=WAIT) is None   # closed: no block
    with pytest.raises(RuntimeError, match="closed"):
        ch.publish(2, make_sample(2))


def test_channel_callback_fires_once_per_publish():
    ch = PublicationChannel(window=2)
    seen = []
    unsubscribe = ch.subscribe(lambda snap: seen.append((snap.epoch, snap.seq)))
    ch.publish(1, make_sample(1))
    ch.publish(2, make_sample(2))
    assert ch.publish(2, make_sample(2)) is False   # a dropped duplicate: no call
    unsubscribe()
    ch.publish(3, make_sample(3))
    assert seen == [(1, 1), (2, 2)]


def test_channel_rejects_incomplete_sample():
    ch = PublicationChannel()
    bad = make_sample(1)
    del bad["alpha"]
    with pytest.raises(ValueError, match="alpha"):
        ch.publish(1, bad)
    with pytest.raises(ValueError, match="alpha"):
        as_retained_sample(1, bad)
    with pytest.raises(ValueError, match="window"):
        PublicationChannel(window=0)


# ---------------------------------------------------------------------------
# the trainer publishes beside the durable store
# ---------------------------------------------------------------------------
def test_gibbs_run_publishes_alongside_store(tmp_path):
    ratings, _, _ = synthetic_lowrank(40, 24, k_true=3, nnz=600, noise=0.3, seed=0)
    train, test = train_test_split(ratings, 0.1, seed=1)
    store = SampleStore(tmp_path / "samples", keep=8)
    ch = PublicationChannel(window=8)
    published = []
    ch.subscribe(lambda snap: published.append(snap.epoch))
    sampler = GibbsSampler(train, test, k=4, alpha=2.0, burn_in=3, widths=(8, 32),
                           engine="fused", device=CPU)
    state = sampler.run(8, seed=0, store=store, publish=ch)
    assert not ch.closed                       # the caller closes it
    assert published == store.steps() == [4, 5, 6, 7, 8]
    snap = ch.snapshot()
    assert [d.step for d in snap.draws] == store.steps() and snap.epoch == state.step
    durable = store.load(store.epoch())
    last = snap.draws[-1]
    assert isinstance(last.u, np.ndarray)      # host arrays on both paths
    np.testing.assert_array_equal(last.u, durable.u)
    np.testing.assert_array_equal(last.v, durable.v)
    np.testing.assert_array_equal(last.u, state.u.numpy())
    assert last.alpha == pytest.approx(durable.alpha)
    # thin and a continued chain: the run goes on from the state it is given
    ch2 = PublicationChannel(window=8)
    sampler.run(6, store=None, publish=ch2, thin=2, state=state)
    assert [d.step for d in ch2.snapshot().draws] == [12, 14]


# ---------------------------------------------------------------------------
# the frontend
# ---------------------------------------------------------------------------
def test_frontend_serves_from_channel_without_disk():
    ch = PublicationChannel(window=2)
    ch.publish(5, epoch_coded_sample(5))
    fe = RecommendFrontend(channel=ch, subscribe=False, max_batch=4, device=CPU)
    assert fe.store is None and fe.epoch == 5
    fe.submit(0, topk=1)
    (res,) = fe.flush()
    assert res.epoch == 5 and res.items[0] == 5 % N
    assert res.scores[0] == pytest.approx(5.0)


def test_frontend_requires_a_sample_source():
    with pytest.raises(ValueError, match="sample_root"):
        RecommendFrontend(device=CPU)
    ch = PublicationChannel()
    with pytest.raises(TimeoutError):
        RecommendFrontend(channel=ch, subscribe=False, wait_first_publish_s=0.05,
                          device=CPU)
    ch.close()
    with pytest.raises(RuntimeError, match="closed before the first publish"):
        RecommendFrontend(channel=ch, subscribe=False, device=CPU)


def test_frontend_epoch_monotone_and_stale_publish_ignored():
    ch = PublicationChannel(window=4)
    ch.publish(10, epoch_coded_sample(10))
    fe = RecommendFrontend(channel=ch, subscribe=False, max_batch=4,
                           max_samples=1, device=CPU)
    ch.publish(8, epoch_coded_sample(8))            # a straggler
    assert fe.refresh() is False and fe.epoch == 10
    ch.publish(12, epoch_coded_sample(12))
    assert fe.refresh() is True and fe.epoch == 12
    fe.submit(1, topk=1)
    (res,) = fe.flush()
    assert res.epoch == 12 and res.items[0] == 12 % N


def test_frontend_prefers_channel_over_store(tmp_path):
    root = tmp_path / "samples"
    store = SampleStore(root, keep=4)
    store.retain(1, epoch_coded_sample(1))
    store.wait()
    ch = PublicationChannel(window=1)
    fe = RecommendFrontend(root, channel=ch, subscribe=False, max_batch=4,
                           device=CPU)
    assert fe.epoch == 1                            # cold start from disk
    ch.publish(6, epoch_coded_sample(6))
    assert fe.refresh() is True and fe.epoch == 6   # the push wins
    fe.submit(2, topk=1)
    (res,) = fe.flush()
    assert res.items[0] == 6 % N


def test_frontend_rebinds_same_shape_and_keeps_fold_in_cache():
    ch = PublicationChannel(window=4)
    for s in range(3):                              # S = 3 to start
        ch.publish(s, make_sample(100 + s))
    fe = RecommendFrontend(channel=ch, subscribe=False, max_batch=8, device=CPU)
    fe.submit_ratings([1, 2, 3], [4.0, 3.0, 5.0], topk=3)
    fe.flush()
    assert fe.foldin_cache.stats()["entries"] == 1
    ch.publish(3, make_sample(103))                 # S grows: rebuild, cache cleared
    assert fe.refresh() is True and fe.rebinds == 0
    assert fe.foldin_cache.stats()["entries"] == 0
    fe.submit_ratings([1, 2, 3], [4.0, 3.0, 5.0], topk=3)
    fe.flush()
    ch.publish(4, make_sample(104))                 # same shape: rebind, cache kept
    assert fe.refresh() is True and fe.rebinds == 1 and fe.swaps == 3
    assert fe.foldin_cache.stats()["entries"] == 1
    with pytest.raises(ValueError, match="user id"):
        fe.submit(M, topk=3)
    with pytest.raises(ValueError, match="item ids"):
        fe.submit_ratings([N], [1.0])
    # a zero-rating request serves the prior-mean user
    fe.submit_ratings([], [], topk=5)
    (res,) = fe.flush()
    assert res.items.shape == (5,) and np.all(res.items >= 0)


def test_frontend_subscriber_adopts_publishes_and_drains_on_close():
    ch = PublicationChannel(window=2)
    ch.publish(1, epoch_coded_sample(1))
    fe = RecommendFrontend(channel=ch, max_batch=4, device=CPU)
    try:
        for step in (2, 3, 4):
            ch.publish(step, epoch_coded_sample(step))
            assert fe.wait_epoch(step, timeout=WAIT)
            fe.submit(0, topk=1)
            (res,) = fe.flush()
            assert res.epoch >= step and res.items[0] == res.epoch % N
        ch.publish(5, epoch_coded_sample(5))
        ch.close()
        assert fe.wait_epoch(5, timeout=WAIT)       # the last publish is adopted
    finally:
        fe.close()
    assert fe.swaps == 5 and fe.rebinds == 3 and len(fe.publish_to_swap_s) == 5


@pytest.mark.parametrize("n_hosts", [None, 3])
def test_frontend_serves_what_the_reference_serves(n_hosts):
    """The same channel draws, warm and cold requests and seen-item index
    into both frontends (the reference's single-host or tier layout): the
    same items, scores within 1e-5."""
    rng = np.random.default_rng(7)
    ratings, _, _ = synthetic_lowrank(M, N, k_true=2, nnz=120, seed=3)
    ours, theirs = PublicationChannel(window=3), JChannel(window=3)
    for s in range(3):
        d = make_sample(20 + s)
        d["global_mean"] = np.float32(3.0)
        ours.publish(s, d)
        theirs.publish(s, d)
    kw = dict(subscribe=False, seen=ratings, max_batch=5, n_hosts=n_hosts)
    fe = RecommendFrontend(channel=ours, device=CPU, **kw)
    jfe = JFrontend(channel=theirs, **kw)
    cold = [(rng.choice(N, d, replace=False), rng.normal(3, 1, d)) for d in (3, 7)]
    for f in (fe, jfe):
        for u in (0, 5, 23, 7):
            f.submit(u, topk=4)
        for items, vals in cold:
            f.submit_ratings(items, vals, topk=4)
    got, want = fe.flush(), jfe.flush()
    assert [r.ticket for r in got] == [r.ticket for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.items, b.items)
        np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5, atol=1e-5)
        assert a.epoch == b.epoch == 2


def test_cold_requests_are_the_fold_in_posterior_means():
    """A cold batch through the frontend ranks exactly what fold_in
    (sample=False) and recommend_factors give, the rated items excluded."""
    ch = PublicationChannel(window=2)
    for s in range(2):
        ch.publish(s, make_sample(50 + s))
    fe = RecommendFrontend(channel=ch, subscribe=False, max_batch=8,
                           engine="fused", device=CPU)
    items, vals = np.array([1, 4, 9], np.int32), np.array([4.0, 1.0, 2.5], np.float32)
    fe.submit_ratings(items, vals, topk=6)
    (res,) = fe.flush()
    ens = fe.ensemble
    u = fold_in(None, SparseRatings(np.zeros(3, np.int32), items, vals, (1, N)), ens,
                sample=False, engine="fused")
    want_v, want_i = TopNRecommender(ens, device=CPU).recommend_factors(
        u, 6, exclude=[items], fetch_hint=16)
    np.testing.assert_array_equal(res.items, want_i[0])
    np.testing.assert_array_equal(res.scores, want_v[0])
    assert not np.isin(res.items, items).any()


def test_ensemble_from_arrays_matches_draw_construction():
    draws = [as_retained_sample(s, make_sample(s)) for s in (3, 4)]
    a = PosteriorEnsemble(draws, device=CPU)
    b = PosteriorEnsemble.from_arrays(
        np.stack([d.u for d in draws]), torch.as_tensor(np.stack([d.v for d in draws])),
        hyper_u_mu=np.stack([d.hyper_u_mu for d in draws]),
        hyper_u_lam=np.stack([d.hyper_u_lam for d in draws]),
        hyper_v_mu=np.stack([d.hyper_v_mu for d in draws]),
        hyper_v_lam=np.stack([d.hyper_v_lam for d in draws]),
        global_mean=0.0, alpha=2.0, steps=[3, 4], device=CPU)
    assert b.epoch == 4 and b.shape_key() == a.shape_key()
    for x, y in zip(a.scoring_matrices(), b.scoring_matrices()):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="ascending"):
        PosteriorEnsemble.from_arrays(
            b.u, b.v, hyper_u_mu=b.hyper_u_mu, hyper_u_lam=b.hyper_u_lam,
            hyper_v_mu=b.hyper_u_mu, hyper_v_lam=b.hyper_u_lam, global_mean=0.0,
            alpha=2.0, steps=[4, 3], device=CPU)
