"""The port's SGLD samplers and schedules against the JAX package's, on the
CPU: `repro_torch.optim.schedule` and `repro_torch.core.sgld` against
`repro.optim.schedule` and `repro.core.sgld` on the same numpy inputs.

The randomness is the reference's own: the row ids its minibatch draws
(`jax.random.randint` under `fold_in(key, b)`, `repro/core/sgld.py:118-119`),
the Langevin z and the Normal-Wishart draws, taken under the key splits of
`SGLDSampler._sweep_impl` (`split(state.key, 7)`) and handed to the port
as an SGLDNoise. The distributed sampler's JAX side runs once, in a
subprocess that forces 4 host devices, and writes its init state, its
replayed noise (rows under `fold_in(fold_in(key_sel, p), s)`, z by global
id) and one step of each mode to an .npz, as tests/test_torch_distributed.py
does.

Data: the reference tests' splits, `synthetic_lowrank(300, 200, k_true=6,
nnz=9000, noise=0.3, seed=2)` split 0.1 with seed 3 (tests/test_sgld.py) and,
for the distributed sampler, `synthetic_lowrank(300, 200, k_true=8,
nnz=9000, noise=0.3, seed=3)` split 0.1 with seed 4.

Tolerances, and why:
  * alloc_minibatch, data_init_scale: equal (the same numpy code).
  * the schedules and the temperature ramp: rtol 1e-6. The port computes
    a host step's values in float64, the reference in float32.
  * row gradients, the minibatch gradient, the Langevin update: rtol 1e-5,
    atol 1e-5 (fp32 einsums in another library's order).
  * a 3-step chain, one distributed step per mode: rtol 1e-4, atol 1e-3,
    the port's half-sweep tolerance (tests/test_torch_gibbs.py).
  * the full-budget gradient against dense numpy: rtol 2e-4, atol 2e-4
    (tests/test_sgld.py's).
  * accuracy: the SGLD posterior mean within 0.05 RMSE of fused Gibbs
    (tests/test_sgld.py::test_sgld_converges_and_tracks_gibbs).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest-xdist runs several workers on the same cores,
# and torch's default thread count each would oversubscribe them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sgld as js  # noqa: E402
from repro.data import synthetic_lowrank, train_test_split  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch.core import distributed as td  # noqa: E402
from repro_torch.core import exchange  # noqa: E402
from repro_torch.core import gibbs as tg  # noqa: E402
from repro_torch.core import sgld as ts  # noqa: E402
from repro_torch.core.hyper import WishartNoise  # noqa: E402
from repro_torch.data import SparseRatings  # noqa: E402
from repro_torch.launch import train as bpmf_train  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-3)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
MODES = ("ring", "allgather", "async")
P, DK, DALPHA, DSEED, DMB = 4, 16, 4.0, 7, 1024
CPU4 = [torch.device("cpu")] * P


def _t(a):
    return torch.tensor(np.asarray(a))


def _port(r) -> SparseRatings:
    return SparseRatings(r.rows, r.cols, r.vals, r.shape)


@pytest.fixture(scope="module")
def small_split():
    ratings, _, _ = synthetic_lowrank(300, 200, k_true=6, nnz=9000, noise=0.3, seed=2)
    return train_test_split(ratings, 0.1, seed=3)


def _nw_noise(key, n, k) -> WishartNoise:
    """The draws `repro.core.hyper.sample_normal_wishart(key, ...)` takes
    for a factor matrix of n rows under the default prior (nu0 = k)."""
    kw, km = jax.random.split(key)
    kn, kc = jax.random.split(kw)
    nu = jnp.asarray(float(k), jnp.float32) + jnp.asarray(n, jnp.float32)
    dfs = nu - jnp.arange(k, dtype=jnp.float32)
    chi2 = 2.0 * jax.random.gamma(kc, dfs / 2.0, dtype=jnp.float32)
    normal = jax.random.normal(kn, (k, k), jnp.float32)
    z = jax.random.normal(km, (k,), jnp.float32)
    return WishartNoise(chi2=_t(chi2), normal=_t(normal), z=_t(z))


def _bucket_rows(key, buckets, n_rows) -> tuple:
    """The row ids `minibatch_likelihood_grad(key, ...)` draws, bucket by
    bucket (None where the quota covers the bucket)."""
    out = []
    for b, (bucket, s_b) in enumerate(zip(buckets, n_rows)):
        r = bucket.indices.shape[0]
        out.append(None if s_b >= r else _t(
            jax.random.randint(jax.random.fold_in(key, b), (s_b,), 0, r)).long())
    return tuple(out)


def _step_noise(sampler, state) -> ts.SGLDNoise:
    """The noise the JAX SGLDSampler's next step takes from state.key."""
    _, k_hv, k_hu, k_sv, k_su, k_nv, k_nu = jax.random.split(state.key, 7)
    m, n, k = sampler.m, sampler.n, sampler.k
    hyper = int(state.step) % sampler.hyper_every == 0
    return ts.SGLDNoise(
        hyper_v=_nw_noise(k_hv, n, k) if hyper else None,
        hyper_u=_nw_noise(k_hu, m, k) if hyper else None,
        rows_v=_bucket_rows(k_sv, sampler.item_buckets, sampler.item_rows),
        rows_u=_bucket_rows(k_su, sampler.user_buckets, sampler.user_rows),
        z_v=_t(jax.random.normal(k_nv, (n, k), jnp.float32)),
        z_u=_t(jax.random.normal(k_nu, (m, k), jnp.float32)),
    )


def _port_state(jst):
    return tg.state_from_numpy(u=jst.u, v=jst.v, hyper_u=jst.hyper_u, hyper_v=jst.hyper_v,
                               step=int(jst.step), pred_sum=jst.pred_sum,
                               pred_count=int(jst.pred_count), device=CPU)


# ---------------------------------------------------------------------------
# the numpy helpers and the schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("budget", [512, 2048, 10**9])
def test_alloc_minibatch_equal_to_reference(small_split, budget):
    train, _ = small_split
    jsam = js.SGLDSampler(train, None, k=4, minibatch=budget)
    tsam = ts.SGLDSampler(_port(train), None, k=4, minibatch=budget, device=CPU)
    for plan_j, plan_t in ((jsam.user_plan_host, tsam.user_plan_host),
                           (jsam.item_plan_host, tsam.item_plan_host)):
        assert ts.alloc_minibatch(plan_t, budget) == js.alloc_minibatch(plan_j, budget)
    assert (tsam.user_rows, tsam.user_scales) == (jsam.user_rows, jsam.user_scales)
    assert (tsam.item_rows, tsam.item_scales) == (jsam.item_rows, jsam.item_scales)


def test_data_init_scale_equal_to_reference():
    rng = np.random.default_rng(0)
    for vals in (np.zeros(0, np.float32), np.ones(50, np.float32),
                 rng.normal(0, 2.0, 5000).astype(np.float32),
                 rng.normal(0, 0.01, 300).astype(np.float32)):
        for k in (4, 16, 64):
            assert ts.data_init_scale(vals, k) == js.data_init_scale(vals, k)


@pytest.mark.parametrize("kw", [dict(peak=0.3, decay=0.33, t0=100.0),
                                dict(peak=1.0, decay=1.0, t0=50.0),
                                dict(peak=0.3, decay=0.55, t0=200.0, floor=0.05)])
def test_sgld_step_schedule_matches_reference(kw):
    steps = np.arange(1001)
    want = np.asarray(jsched.sgld_step_schedule(jnp.asarray(steps), **kw))
    host = np.array([tsched.sgld_step_schedule(int(s), **kw) for s in steps])
    np.testing.assert_allclose(host, want, rtol=1e-6)
    got = tsched.sgld_step_schedule(torch.arange(1001), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("warmup", [0, 1, 250])
def test_effective_temperature_matches_reference(warmup):
    steps = np.arange(1001)
    want = np.array([float(js.effective_temperature(jnp.asarray(s, jnp.int32), 0.7, warmup))
                     for s in steps])
    got = np.array([ts.effective_temperature(int(s), 0.7, warmup) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_cosine_schedule_matches_reference():
    kw = dict(peak_lr=3e-4, warmup_steps=100, total_steps=1000)
    steps = np.arange(1101)
    want = np.asarray(jsched.cosine_schedule(jnp.asarray(steps), **kw))
    host = np.array([tsched.cosine_schedule(int(s), **kw) for s in steps])
    np.testing.assert_allclose(host, want, rtol=1e-6)
    np.testing.assert_allclose(tsched.cosine_schedule(torch.arange(1101), **kw).numpy(),
                               want, rtol=1e-6)


# ---------------------------------------------------------------------------
# gradients and the update
# ---------------------------------------------------------------------------
def test_row_grads_matches_reference():
    rng = np.random.default_rng(0)
    n, m, k, s, w = 40, 30, 8, 25, 6
    factors = rng.normal(size=(m, k)).astype(np.float32)
    counter = rng.normal(size=(n, k)).astype(np.float32)
    idx = rng.integers(0, n, (s, w)).astype(np.int32)
    val = rng.normal(size=(s, w)).astype(np.float32)
    msk = (rng.random((s, w)) < 0.7).astype(np.float32)
    items = rng.integers(0, m, (s,)).astype(np.int32)
    args = (factors, counter, idx, val, msk, items)
    want = np.asarray(js.row_grads(*(jnp.asarray(a) for a in args)))
    got = ts.row_grads(*(_t(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)


@pytest.mark.parametrize("budget", [512, 10**9])
@pytest.mark.parametrize("side", ["user", "item"])
def test_minibatch_likelihood_grad_matches_reference_under_replayed_rows(
        small_split, side, budget):
    train, test = small_split
    jsam = js.SGLDSampler(train, test, k=8, alpha=2.0, minibatch=budget)
    tsam = ts.SGLDSampler(_port(train), _port(test), k=8, alpha=2.0, minibatch=budget,
                          device=CPU)
    rng = np.random.default_rng(1)
    u = rng.normal(size=(train.shape[0], 8)).astype(np.float32)
    v = rng.normal(size=(train.shape[1], 8)).astype(np.float32)
    f, c = (u, v) if side == "user" else (v, u)
    plan = "user" if side == "user" else "item"
    jb, tb = getattr(jsam, f"{plan}_buckets"), getattr(tsam, f"{plan}_buckets")
    n_rows, scales = getattr(jsam, f"{plan}_rows"), getattr(jsam, f"{plan}_scales")
    key = jax.random.PRNGKey(3)
    # jitted: one compile instead of one for each eager op
    grad = jax.jit(lambda k, f, c: js.minibatch_likelihood_grad(k, f, c, jb, n_rows, scales))
    want = np.asarray(grad(key, jnp.asarray(f), jnp.asarray(c)))
    # the draws the reference just took from the key
    rows = _bucket_rows(jax.random.clone(key), jb, n_rows)
    assert (budget < 10**9) == any(r is not None for r in rows)
    got = ts.minibatch_likelihood_grad(_t(f), _t(c), tb, n_rows, scales, rows)
    np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)


@pytest.mark.parametrize("clip", [3.0, None])
def test_langevin_update_matches_reference_under_replayed_z(clip):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(50, 8)).astype(np.float32)
    # large gradients on some rows so that the clip binds there
    grad = (rng.normal(size=(50, 8)) * np.where(np.arange(50) % 3 == 0, 1e3, 1.0)[:, None]
            ).astype(np.float32)
    gain = rng.uniform(0.1, 2.0, 50).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(js.langevin_update(key, jnp.asarray(x), jnp.asarray(grad),
                                         jnp.asarray(gain), 0.03, 0.8, clip=clip))
    z = _t(jax.random.normal(jax.random.clone(key), x.shape, jnp.float32))
    got = ts.langevin_update(_t(x), _t(grad), _t(gain), 0.03, 0.8, z=z, clip=clip)
    np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)
    if clip is not None:
        unclipped = ts.langevin_update(_t(x), _t(grad), _t(gain), 0.03, 0.8, z=z, clip=None)
        assert not torch.allclose(got, unclipped)


# ---------------------------------------------------------------------------
# the single-device sampler
# ---------------------------------------------------------------------------
def test_three_step_chain_matches_reference_under_replayed_noise(small_split):
    """hyper_every=2: steps 0 and 2 draw hypers, step 1 keeps them; the
    temperature ramps over the first 2 steps; burn-in 1."""
    train, test = small_split
    kw = dict(k=8, alpha=2.0, burn_in=1, minibatch=1024, hyper_every=2, temp_warmup=2)
    jsam = js.SGLDSampler(train, test, **kw)
    tsam = ts.SGLDSampler(_port(train), _port(test), **kw, device=CPU)
    jst = jsam.init(5)
    tst = _port_state(jst)
    for i in range(3):
        noise = _step_noise(jsam, jst)
        assert (noise.hyper_v is None) == (i == 1)
        jst = jsam.sweep(jst)
        tst = tsam.sweep(tst, noise)
    assert tst.step == 3 and tst.pred_count == int(jst.pred_count) == 2
    for name in ("u", "v", "pred_sum"):
        np.testing.assert_allclose(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)),
                                   err_msg=name, **TOL)
    for side in ("hyper_u", "hyper_v"):
        for f in ("mu", "lam"):
            np.testing.assert_allclose(getattr(getattr(tst, side), f).numpy(),
                                       np.asarray(getattr(getattr(jst, side), f)),
                                       err_msg=f"{side}.{f}", **TOL)
    assert tsam.rmse(tst) == pytest.approx(jsam.rmse(jst), rel=1e-4)


def test_thinning_keeps_hypers_and_counts_and_skips_their_work(small_split, monkeypatch):
    """The reference's thinning test on the port, plus: a thinned step
    neither draws hypers nor predicts (their calls are counted), and its
    noise carries no Wishart draws."""
    train, test = small_split
    kw = dict(k=8, alpha=2.0, burn_in=10, minibatch=1024, step_size=0.3)
    a = ts.SGLDSampler(_port(train), _port(test), **kw, device=CPU)
    b = ts.SGLDSampler(_port(train), _port(test), **kw, device=CPU)
    sa, sb = a.init(5), b.init(5)
    for _ in range(12):
        sa, sb = a.sweep(sa), b.sweep(sb)
    assert torch.equal(sa.u, sb.u) and torch.equal(sa.v, sb.v)

    calls = {"hyper": 0, "predict": 0}
    real_nw = ts.sample_normal_wishart

    def counted_nw(*args):
        calls["hyper"] += 1
        return real_nw(*args)

    monkeypatch.setattr(ts, "sample_normal_wishart", counted_nw)
    c = ts.SGLDSampler(_port(train), _port(test), **kw, hyper_every=4, accum_every=3,
                       device=CPU)
    real_predict = c._predict

    def counted_predict(u, v):
        calls["predict"] += 1
        return real_predict(u, v)

    monkeypatch.setattr(c, "_predict", counted_predict)
    sc = c.init(5)
    lam0 = None
    for i in range(8):
        assert (c.draw_noise(i).hyper_v is None) == (i % 4 != 0)
        sc = c.sweep(sc)
        if i % 4 == 0:
            lam0 = sc.hyper_v.lam
        else:
            assert torch.equal(sc.hyper_v.lam, lam0)     # held, not redrawn
    assert calls == {"hyper": 4, "predict": 0} and sc.pred_count == 0
    for _ in range(6):
        sc = c.sweep(sc)
    # steps 10 and 13 of 8..13 collect; steps 8 and 12 draw hypers
    assert calls == {"hyper": 8, "predict": 2} and sc.pred_count == 2


def test_full_budget_gradient_is_exact_against_dense_numpy(small_split):
    train, test = small_split
    s = ts.SGLDSampler(_port(train), _port(test), k=8, alpha=2.0, minibatch=10**9,
                       device=CPU)
    assert all(sc == 1.0 for sc in s.user_scales + s.item_scales)
    noise = s.draw_noise(0)
    assert all(r is None for r in noise.rows_u + noise.rows_v)
    rng = np.random.default_rng(1)
    u = rng.normal(size=(train.shape[0], 8)).astype(np.float32)
    v = rng.normal(size=(train.shape[1], 8)).astype(np.float32)
    got = ts.minibatch_likelihood_grad(_t(u), _t(v), s.user_buckets, s.user_rows,
                                       s.user_scales, noise.rows_u)
    c = train.centered()
    want = np.zeros_like(u)
    for r, cc, val in zip(c.rows, c.cols, c.vals):
        want[r] += (val - u[r] @ v[cc]) * v[cc]
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_sgld_converges_and_tracks_gibbs(small_split):
    """The reference's accuracy gate on the port: the SGLD posterior mean
    within 0.05 RMSE of fused Gibbs after 15 sweeps."""
    train, test = _port(small_split[0]), _port(small_split[1])
    g = tg.GibbsSampler(train, test, k=16, alpha=4.0, burn_in=5, engine="fused", device=CPU)
    gs = g.run(15, seed=0)
    s = ts.SGLDSampler(train, test, k=16, alpha=4.0, burn_in=250, minibatch=2048,
                       step_size=1.0, step_decay=1.0, step_t0=50.0, clip=6.0,
                       temp_warmup=250, hyper_every=5, accum_every=5, device=CPU)
    ss = s.run(500, seed=0)
    assert ss.pred_count == 50
    assert s.rmse(ss) - g.rmse(gs) < 0.05, (s.rmse(ss), g.rmse(gs))


# ---------------------------------------------------------------------------
# the distributed sampler against the JAX package
# ---------------------------------------------------------------------------
JAX_SIDE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.core import distributed as jd
from repro.core import sgld as js
from repro.data import synthetic_lowrank, train_test_split

P, K, ALPHA, SEED, MB = {P}, {K}, {ALPHA}, {SEED}, {MB}
ratings, _, _ = synthetic_lowrank(300, 200, k_true=8, nnz=9000, noise=0.3, seed=3)
train, test = train_test_split(ratings, 0.1, seed=4)
m, n = train.shape
out = {{}}


def nw_noise(key, rows, tag):
    kw, km = jax.random.split(key)
    kn, kc = jax.random.split(kw)
    dfs = (jnp.asarray(float(K), jnp.float32) + jnp.asarray(rows, jnp.float32)
           - jnp.arange(K, dtype=jnp.float32))
    out[tag + "_chi2"] = np.asarray(2.0 * jax.random.gamma(kc, dfs / 2.0, dtype=jnp.float32))
    out[tag + "_normal"] = np.asarray(jax.random.normal(kn, (K, K), jnp.float32))
    out[tag + "_z"] = np.asarray(jax.random.normal(km, (K,), jnp.float32))


def save(tag, st):
    out[tag + "/u"], out[tag + "/v"] = np.asarray(st.u), np.asarray(st.v)
    for side in ("u", "v"):
        h = getattr(st, "hyper_" + side)
        out[tag + "/hyper_" + side + "_mu"] = np.asarray(h.mu)
        out[tag + "/hyper_" + side + "_lam"] = np.asarray(h.lam)
    if st.v_eval is not None:
        out[tag + "/v_eval"] = np.asarray(st.v_eval)


for mode in jd.DIST_MODES:
    d = js.DistributedSGLD(train, test, k=K, alpha=ALPHA, width="auto", mode=mode,
                           minibatch=MB)
    st = d.init(SEED)
    if "init/u" not in out:
        save("init", st)
    # the split of make_sgld_sweep, then each draw as the sweep takes it
    _, k_hv, k_hu, k_sv, k_su, k_nv, k_nu = jax.random.split(st.key, 7)
    nw_noise(k_hv, n, mode + "/hyper_v")
    nw_noise(k_hu, m, mode + "/hyper_u")
    for side, sel, plan in (("v", k_sv, d.v_plan), ("u", k_su, d.u_plan)):
        p_n, _, r, w = plan.indices.shape
        s_rows = int(min(r, max(1, round(MB / (p_n * w)))))
        out[mode + "/s_rows_" + side] = np.asarray(s_rows)
        for p in range(p_n):
            kp = jax.random.fold_in(sel, p)
            if mode == "allgather":
                if s_rows < r:
                    out[f"{{mode}}/rows_{{side}}/{{p}}"] = np.asarray(
                        jax.random.randint(kp, (p_n * s_rows,), 0, p_n * r))
                continue
            for s in range(p_n):
                if s_rows < r:
                    out[f"{{mode}}/rows_{{side}}/{{p}}/{{s}}"] = np.asarray(
                        jax.random.randint(jax.random.fold_in(kp, s), (s_rows,), 0, r))
    out[mode + "/z_v"] = np.asarray(jd._per_item_noise(k_nv, jnp.arange(n), K))
    out[mode + "/z_u"] = np.asarray(jd._per_item_noise(k_nu, jnp.arange(m), K))
    save("step/" + mode, d.sweep(st))
np.savez(sys.argv[1], **out)
""".format(P=P, K=DK, ALPHA=DALPHA, SEED=DSEED, MB=DMB)


@pytest.fixture(scope="module")
def dist_data():
    ratings, _, _ = synthetic_lowrank(300, 200, k_true=8, nnz=9000, noise=0.3, seed=3)
    train, test = train_test_split(ratings, 0.1, seed=4)
    return _port(train), _port(test)


@pytest.fixture(scope="module")
def dist_ref(tmp_path_factory):
    """The JAX DistributedSGLD's init state, replayed noise and one step of
    each mode at P = 4."""
    path = tmp_path_factory.mktemp("sgld") / "reference.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", JAX_SIDE, str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(path))


def _dist(data, mode, **kw) -> ts.DistributedSGLD:
    train, test = data
    return ts.DistributedSGLD(train, test, devices=CPU4, k=DK, alpha=DALPHA, width="auto",
                              mode=mode, **{"minibatch": DMB, **kw})


def _dist_noise(ref, mode) -> ts.SGLDNoise:
    def wishart(side):
        return WishartNoise(*(_t(ref[f"{mode}/hyper_{side}_{name}"])
                              for name in ("chi2", "normal", "z")))

    def rows(side):
        def get(key):
            return _t(ref[key]).long() if key in ref else None

        if mode == "allgather":
            return tuple(get(f"{mode}/rows_{side}/{p}") for p in range(P))
        return tuple(tuple(get(f"{mode}/rows_{side}/{p}/{s}") for s in range(P))
                     for p in range(P))

    return ts.SGLDNoise(hyper_v=wishart("v"), hyper_u=wishart("u"), rows_v=rows("v"),
                        rows_u=rows("u"), z_v=_t(ref[f"{mode}/z_v"]),
                        z_u=_t(ref[f"{mode}/z_u"]))


def _dist_init(ref, mode) -> td.DistState:
    return td.dist_state_from_numpy(
        u=ref["init/u"], v=ref["init/v"], devices=CPU4,
        hyper_u=(ref["init/hyper_u_mu"], ref["init/hyper_u_lam"]),
        hyper_v=(ref["init/hyper_v_mu"], ref["init/hyper_v_lam"]),
        v_eval=ref["init/v"] if mode == "async" else None)


@pytest.mark.parametrize("mode", MODES)
def test_distributed_step_matches_reference(dist_data, dist_ref, mode):
    d = _dist(dist_data, mode)
    assert (d.cfg.v_rows, d.cfg.u_rows) == (int(dist_ref[f"{mode}/s_rows_v"]),
                                            int(dist_ref[f"{mode}/s_rows_u"]))
    noise = _dist_noise(dist_ref, mode)
    flat = [r for row in noise.rows_v for r in (row if isinstance(row, tuple) else (row,))]
    assert any(r is not None for r in flat)
    st = d.sweep(_dist_init(dist_ref, mode), noise)
    assert st.step == 1 and (st.v_eval is not None) == (mode == "async")
    tag = f"step/{mode}"
    for name in ("u", "v") + (("v_eval",) if mode == "async" else ()):
        got = torch.stack(getattr(st, name)).numpy()
        np.testing.assert_allclose(got, dist_ref[f"{tag}/{name}"], err_msg=name, **TOL)
    for side in ("hyper_u", "hyper_v"):
        h = getattr(st, side)
        for f in ("mu", "lam"):
            np.testing.assert_allclose(getattr(h, f).numpy(), dist_ref[f"{tag}/{side}_{f}"],
                                       err_msg=f"{side}.{f}", **TOL)


def test_distributed_draws_take_the_reference_layout(dist_data):
    """The port's own draws: ids in range, one tensor a (shard, ring step)
    for ring and async, one a shard for allgather, on the shard's device."""
    for mode in MODES:
        d = _dist(dist_data, mode)
        noise = d.draw_noise()
        _, _, r, _ = d.v_plan.indices.shape
        if mode == "allgather":
            assert [x.shape for x in noise.rows_v] == [(P * d.cfg.v_rows,)] * P
            assert all(int(x.max()) < P * r for x in noise.rows_v)
        else:
            assert [[x.shape for x in row] for row in noise.rows_v] == [
                [(d.cfg.v_rows,)] * P] * P
            assert all(int(x.max()) < r for row in noise.rows_v for x in row)
        assert noise.z_v.shape == (d.n, DK) and noise.z_u.shape == (d.m, DK)


def test_distributed_async_fresh_v_bit_equal_to_ring(dist_data):
    """Async's movie half-step reads the same blocks in the same order
    under the same rows as ring's: its fresh v is ring's, bit for bit."""
    ring, asyn = _dist(dist_data, "ring"), _dist(dist_data, "async")
    s0 = ring.init(DSEED)
    noise = ring.draw_noise()
    v_ring = ring.gather_factors(ring.sweep(s0, noise))[1]
    s1 = asyn.sweep(asyn.init(DSEED), noise)
    assert np.array_equal(asyn.gather_factors(s1, coupled=False)[1], v_ring)
    assert all(torch.equal(a, b) for a, b in zip(s1.v_eval, s0.v))


def test_full_budget_ring_gradient_matches_allgather_and_a_wrong_way_ring_fails(
        dist_data, monkeypatch):
    """At a budget that covers every row the ring's likelihood gradient is
    allgather's exact one; the plant of chip_smoke.py phase sgld, a ring
    that forwards to p - 1, misses it."""
    ring = _dist(dist_data, "ring", minibatch=10**9)
    gather = _dist(dist_data, "allgather", minibatch=10**9)
    assert (ring.cfg.u_rows, ring.cfg.v_rows) == tuple(
        p.indices.shape[2] for p in (ring.u_plan, ring.v_plan))
    st = ring.init(DSEED)
    none = ((None,) * P,) * P

    def grads(d, rows):
        return torch.cat(d._grad_phase(st.u, st.v, d._v, rows, d.cfg.v_rows)).numpy()

    want = grads(gather, (None,) * P)
    np.testing.assert_allclose(grads(ring, none), want, **TOL)
    noise = ring.draw_noise()
    np.testing.assert_allclose(ring.gather_factors(ring.sweep(st, noise))[1],
                               gather.gather_factors(gather.sweep(st, noise._replace(
                                   rows_v=(None,) * P, rows_u=(None,) * P)))[1], **TOL)
    monkeypatch.setattr(exchange.RingExchange, "shift", -1)
    assert not np.allclose(grads(ring, none), want, **TOL)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv, tail", [
    ([], "retained"),
    (["--mode", "async", "--shards", "4"], "(4 shards, engine=sgld, mode=async, plan=balanced)"),
])
def test_launcher_trains_sgld_on_the_cpu(capsys, argv, tail):
    bpmf_train.main(["--bpmf", "--engine", "sgld", "--device", "cpu", "--sweeps", "30",
                     "--burn-in", "10", "--scale", "0.002", "--minibatch", "1024", *argv])
    out = capsys.readouterr().out
    assert "30 steps" in out and tail in out
    rmse = float(out.split("test rmse ")[1].split()[0].rstrip(";"))
    assert np.isfinite(rmse)
