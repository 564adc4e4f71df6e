"""The port's sampler against the JAX sampler on the same inputs and the
same noise: the Normal-Wishart draw, one half-sweep per engine, a 3-sweep
chain, and the README quickstart end to end (train -> retain -> top-N).

The noise is the reference's own: `jax.random` draws taken under the key
splits of `repro.core.gibbs.GibbsSampler._sweep_impl` and
`repro.core.hyper.sample_normal_wishart`, handed to the port as tensors.

Tolerances, and why:
  * Normal-Wishart (mu, lam): rtol 1e-4, atol 1e-4. Three fp32 Cholesky
    factorisations and two triangular solves of a K x K matrix in another
    library's order.
  * half-sweep factors: rtol 1e-4, atol 1e-3, the JAX kernel tests' own
    (tests/test_kernels.py:171); bf16 gather the same, since both packages
    round the gathered factors to bf16 at the same place.
  * 3-sweep chain: rtol 1e-4, atol 1e-5 on the factors and the predictive
    sums (observed difference 4e-7 after three sweeps at K=16); the
    hyper precision, whose entries are ~1e2, rtol 1e-4, atol 1e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest-xdist runs several workers on the same cores,
# and torch's default thread count each would oversubscribe them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import SampleStore as JSampleStore  # noqa: E402
from repro.core import gibbs as jg  # noqa: E402
from repro.core import hyper as jh  # noqa: E402
from repro.data import movielens_like, train_test_split  # noqa: E402
from repro.serve import PosteriorEnsemble as JEnsemble  # noqa: E402
from repro.serve import TopNRecommender as JTopN  # noqa: E402
from repro_torch.checkpoint import SampleStore  # noqa: E402
from repro_torch.core import gibbs as tg  # noqa: E402
from repro_torch.core import hyper as th  # noqa: E402
from repro_torch.serve import PosteriorEnsemble, SeenIndex, TopNRecommender  # noqa: E402

CPU = "cpu"


def _t(a):
    return torch.tensor(np.asarray(a))


def _nw_noise(key, n, k) -> th.WishartNoise:
    """The draws `repro.core.hyper.sample_normal_wishart(key, ...)` takes
    for a factor matrix of n rows under the default prior (nu0 = k)."""
    kw, km = jax.random.split(key)
    kn, kc = jax.random.split(kw)
    nu = jnp.asarray(float(k), jnp.float32) + jnp.asarray(n, jnp.float32)
    dfs = nu - jnp.arange(k, dtype=jnp.float32)
    chi2 = 2.0 * jax.random.gamma(kc, dfs / 2.0, dtype=jnp.float32)
    normal = jax.random.normal(kn, (k, k), jnp.float32)
    z = jax.random.normal(km, (k,), jnp.float32)
    return th.WishartNoise(chi2=_t(chi2), normal=_t(normal), z=_t(z))


def _sweep_noise(key, m, n, k):
    """(next key, SweepNoise) of one `_sweep_impl` step from state.key."""
    key, k_hv, k_v, k_hu, k_u = jax.random.split(key, 5)
    return key, tg.SweepNoise(
        hyper_v=_nw_noise(k_hv, n, k),
        z_v=_t(jax.random.normal(k_v, (n, k), jnp.float32)),
        hyper_u=_nw_noise(k_hu, m, k),
        z_u=_t(jax.random.normal(k_u, (m, k), jnp.float32)),
    )


def _port_state(js):
    """The port's state from a JAX BPMFState (the key is not carried)."""
    return tg.state_from_numpy(
        u=js.u, v=js.v, hyper_u=js.hyper_u, hyper_v=js.hyper_v,
        step=int(js.step), pred_sum=js.pred_sum, pred_count=int(js.pred_count),
        device=CPU,
    )


@pytest.fixture(scope="module")
def data():
    ratings, _, _ = movielens_like(scale=0.005, seed=0)
    return train_test_split(ratings, 0.1, seed=1)


@pytest.mark.parametrize("n,k", [(50, 8), (400, 16)])
def test_sample_normal_wishart_matches_reference_draws(n, k):
    rng = np.random.default_rng(n + k)
    x = (0.3 * rng.normal(size=(n, k)) + 0.1).astype(np.float32)
    sum_x, sum_xxt = x.sum(0), x.T @ x
    key = jax.random.PRNGKey(n)
    hj = jh.sample_normal_wishart(key, jnp.asarray(sum_x), jnp.asarray(sum_xxt),
                                  n, jh.default_prior(k))
    # the same key on purpose: _nw_noise replays the draws the reference
    # just took from it
    ht = th.sample_normal_wishart(_t(sum_x), _t(sum_xxt), n, th.default_prior(k),
                                  _nw_noise(key, n, k))  # repro-lint: disable=prng-reuse
    np.testing.assert_allclose(ht.lam.numpy(), np.asarray(hj.lam), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ht.mu.numpy(), np.asarray(hj.mu), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("engine,bf16", [
    ("reference", False), ("einsum", False), ("kernel", False),
    ("fused", False), ("fused", True),
])
def test_update_factors_half_sweep_matches_reference(data, engine, bf16):
    """One item half-sweep from the same state and the same z, per engine
    (the JAX kernel engine runs its Pallas kernels in interpret mode, the
    fused engine its jnp path)."""
    train, test = data
    k = 16
    js = jg.GibbsSampler(train, test, k=k, alpha=4.0, engine=engine)
    ts = tg.GibbsSampler(train, test, k=k, alpha=4.0, engine=engine, device=CPU)
    st = js.init(3)
    hyper = jh.HyperParams(mu=jnp.full((k,), 0.05, jnp.float32),
                           lam=2.0 * jnp.eye(k, dtype=jnp.float32))
    key = jax.random.PRNGKey(11)
    # the same key on purpose: z is the draw update_factors takes from it
    z = jax.random.normal(key, (js.n, k), jnp.float32)
    vj, sj = jg.update_factors(key, st.u, js.item_buckets, js.n, hyper, 4.0,  # repro-lint: disable=prng-reuse
                               engine=engine, bf16_gather=bf16)
    vt, stt = tg.update_factors(
        _t(st.u), ts.item_buckets, ts.n, th.HyperParams(_t(hyper.mu), _t(hyper.lam)),
        4.0, z=_t(z), engine=engine, bf16_gather=bf16,
    )
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(stt.sum_xxt.numpy(), np.asarray(sj.sum_xxt),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("engine", ["einsum", "fused", "kernel"])
def test_three_sweep_chain_matches_reference_chain(data, engine):
    train, test = data
    k = 16
    js = jg.GibbsSampler(train, test, k=k, alpha=4.0, burn_in=1)
    ts = tg.GibbsSampler(train, test, k=k, alpha=4.0, burn_in=1, engine=engine,
                         device=CPU)
    sj = js.init(0)
    st = _port_state(sj)
    key = sj.key
    for _ in range(3):
        key, noise = _sweep_noise(key, js.m, js.n, k)
        sj = js.sweep(sj)
        st = ts.sweep(st, noise)
    for name in ("u", "v", "pred_sum"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    for side in ("hyper_u", "hyper_v"):
        np.testing.assert_allclose(getattr(st, side).lam.numpy(),
                                   np.asarray(getattr(sj, side).lam),
                                   rtol=1e-4, atol=1e-3, err_msg=side)
    assert st.step == int(sj.step) == 3 and st.pred_count == int(sj.pred_count) == 2
    assert ts.rmse(st) == pytest.approx(js.rmse(sj), rel=1e-5)


def test_quickstart_end_to_end_same_top_n(data, tmp_path):
    """The README quickstart in both packages: ratings -> plans -> sweeps
    under the same noise -> retained draws -> PosteriorEnsemble.load ->
    TopNRecommender.recommend with seen-item exclusion: the same items."""
    train, test = data
    k, burn_in, n_sweeps = 16, 2, 5
    js = jg.GibbsSampler(train, test, k=k, alpha=4.0, burn_in=burn_in,
                         engine="fused")
    ts = tg.GibbsSampler(train, test, k=k, alpha=4.0, burn_in=burn_in,
                         engine="fused", device=CPU)
    sj = js.run(n_sweeps, seed=0, store=JSampleStore(tmp_path / "jax", keep=8))

    # the port's chain from the same init and the same per-sweep noise,
    # retaining the draws that run() retains
    j0 = js.init(0)
    st, key = _port_state(j0), j0.key
    store = SampleStore(tmp_path / "torch", keep=8)
    for i in range(n_sweeps):
        key, noise = _sweep_noise(key, js.m, js.n, k)
        st = ts.sweep(st, noise)
        if i >= burn_in:
            ts.retain_sample(st, store)
    store.wait()
    assert ts.rmse(st) == pytest.approx(js.rmse(sj), rel=1e-5)
    assert SampleStore(tmp_path / "torch").steps() == JSampleStore(tmp_path / "jax").steps()

    users = np.arange(0, js.m, 7)
    vj, ij = JTopN(JEnsemble.load(tmp_path / "jax")).recommend(users, 10, seen=train)
    rec = TopNRecommender(PosteriorEnsemble.load(tmp_path / "torch", device=CPU),
                          device=CPU)
    vt, it = rec.recommend(users, 10, seen=SeenIndex(train))
    np.testing.assert_array_equal(it, np.asarray(ij))
    np.testing.assert_allclose(vt, np.asarray(vj), rtol=1e-4, atol=1e-4)
    for row, u in zip(it, users):
        assert not np.isin(row, SeenIndex(train)[u]).any()


# ---------------------------------------------------------------------------
# the order-fixed segment sum
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("tail", [(8,), (8, 8)])
def test_segment_reduce_rows_adds_in_row_order_as_index_add_does(stacked, tail):
    """On the CPU the order-fixed sum gives index_add_'s bits (it adds in
    row order too) and those of the fused kernel's plain version; some
    segments are empty."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    rng = np.random.default_rng(0)
    seg = np.sort(rng.integers(0, 60, 2000)).astype(np.int32)
    shape = ((3,) if stacked else ()) + (2000,) + tail
    rows = torch.tensor((rng.normal(size=shape) * np.exp(3 * rng.normal(size=shape)))
                        .astype(np.float32))
    got = tg.segment_reduce_rows(rows, torch.tensor(kops.segment_offsets(seg, 60)),
                                 stacked=stacked)
    axis = 1 if stacked else 0
    out = list(rows.shape)
    out[axis] = 60
    assert torch.equal(got, torch.zeros(out).index_add_(axis, torch.tensor(seg).long(), rows))
    assert torch.equal(got, kref.segment_sums_in_order(rows, torch.tensor(seg), 60,
                                                       stacked=stacked))


def test_sum_rows_by_id_is_the_scatter_add_in_draw_order():
    """Duplicate ids in random order: the stable sort keeps each id's rows
    in the order they came, so the sum is index_add_'s on the CPU."""
    rng = np.random.default_rng(1)
    ids = torch.tensor(rng.integers(0, 40, 500))
    rows = torch.tensor(rng.normal(size=(500, 8)).astype(np.float32))
    want = torch.zeros(45, 8).index_add_(0, ids, rows)
    assert torch.equal(tg.sum_rows_by_id(rows, ids, 45), want)
