"""Each kernel's plain PyTorch version (what the port's wrappers run for CPU
tensors) against its JAX counterpart on the same numpy inputs. The CUDA
kernels themselves are held against these plain versions on the card in
tests/test_torch_cuda.py.

Tolerances, and why:
  * gather_syrk_seg / masked_syrk fp32: rtol 1e-4, atol 1e-3, the JAX
    kernel tests' own (tests/test_kernels.py); sums of up to a few hundred
    fp32 products taken in another order.
  * bf16 gather: rtol 3e-2, atol 3e-1 (tests/test_kernels.py:209), and the
    two packages round to bf16 at the same place, so they agree to fp32.
  * chol_solve_sample: rtol 2e-3, atol 2e-3 (tests/test_kernels.py:56).
  * topn_scores: the selected indices must be equal; values to 1e-5
    relative (the products are summed in another order). With dyadic inputs
    every sum is exact in fp32, so planted ties are exact in both packages
    and the indices must match to the tie.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest-xdist runs several workers on the same cores,
# and torch's default thread count each would oversubscribe them
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _sorted_segments(rng, r, n_seg):
    extra = np.sort(rng.integers(0, n_seg, r - n_seg))
    return np.sort(np.concatenate([np.arange(n_seg), extra])).astype(np.int32)


def _bucket(rng, r, w, n, n_seg):
    idx = rng.integers(0, n, (r, w)).astype(np.int32)
    val = rng.normal(size=(r, w)).astype(np.float32)
    msk = (rng.random((r, w)) > 0.3).astype(np.float32)
    return idx, val, msk, _sorted_segments(rng, r, n_seg)


@pytest.mark.parametrize("r,w,n,k,n_seg,s", [
    (8, 16, 40, 8, 5, 0),       # ragged segments
    (16, 32, 100, 16, 16, 0),   # identity segments
    (13, 8, 20, 24, 9, 0),      # rows that the kernel wrapper pads
    (24, 256, 60, 64, 11, 0),   # several W tiles at the sweep's K
    (11, 16, 30, 8, 6, 3),      # stacked draws
    # the shapes the CUDA kernel now takes unpadded: R no multiple of 8, W
    # on both sides of the narrow path's threshold, identity (R = 13) and
    # multi-row (R = 21) segments, at the sweep's K and a padded rank
    *[(r, w, 60, k, 13 if r == 13 else 8, 0)
      for r in (13, 21) for w in (1, 5, 12) for k in (64, 24)],
])
@pytest.mark.parametrize("bf16", [False, True])
def test_gather_syrk_seg_plain_matches_jax(r, w, n, k, n_seg, s, bf16):
    rng = np.random.default_rng(r * 100 + w + n_seg)
    idx, val, msk, seg = _bucket(rng, r, w, n, n_seg)
    v = rng.normal(size=((s,) if s else ()) + (n, k)).astype(np.float32)
    ident = n_seg == r
    pj, bj = jops.gather_syrk_seg(
        jnp.asarray(idx), jnp.asarray(val), jnp.asarray(msk), jnp.asarray(seg),
        n_seg, jnp.asarray(v), bf16_gather=bf16, identity_segments=ident,
        interpret=None,
    )
    pt, bt = ops.gather_syrk_seg(
        _t(idx), _t(val), _t(msk), _t(seg), n_seg, _t(v),
        bf16_gather=bf16, identity_segments=ident,
    )
    assert tuple(pt.shape) == tuple(pj.shape) and tuple(bt.shape) == tuple(bj.shape)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("r,w,n,k,s", [(20, 8, 50, 16, 0), (13, 12, 60, 64, 0),
                                       (9, 5, 30, 24, 3)])
def test_gather_syrk_rows_match_jax(r, w, n, k, s):
    """The row-level gather_syrk (every row its own segment) against
    repro.kernels.ops.gather_syrk on its jnp path, at the fp32 tolerance
    above, with a stacked draw axis in the last case; on the CPU it
    launches nothing, and it is gather_syrk_seg with identity segments bit
    for bit."""
    rng = np.random.default_rng(r + w + k)
    idx, val, msk, _ = _bucket(rng, r, w, n, r)
    v = rng.normal(size=((s,) if s else ()) + (n, k)).astype(np.float32)
    pj, bj = jops.gather_syrk(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(msk),
                              jnp.asarray(v), interpret=None)
    ops.reset_launches()
    pt, bt = ops.gather_syrk(_t(idx), _t(val), _t(msk), _t(v))
    assert sum(ops.launches().values()) == 0
    assert tuple(pt.shape) == tuple(pj.shape) == ((s,) if s else ()) + (r, k, k)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-4, atol=1e-3)
    ps, bs = ops.gather_syrk_seg(_t(idx), _t(val), _t(msk), torch.arange(r, dtype=torch.int32),
                                 r, _t(v), identity_segments=True)
    assert torch.equal(pt, ps) and torch.equal(bt, bs)


def _prior(rng, k):
    """A positive definite prior precision and its rhs lam @ mu."""
    a = rng.normal(size=(k, k)).astype(np.float32)
    lam = _t(a @ a.T + k * np.eye(k, dtype=np.float32))
    return lam, lam @ _t(rng.normal(size=k).astype(np.float32))


# the store into the sweep's system buffers: "into" against the flow it
# replaces, the prior copied into every slot and each bucket's statistics
# scaled and added into its items' slots
@pytest.mark.parametrize("r,w,k,kv,n_seg,bf16", [
    (13, 5, 16, 16, 13, False),    # identity segments, narrow rows
    (13, 12, 64, 64, 13, False),   # identity segments, wide rows
    (21, 12, 64, 64, 8, False),    # multi-row segments
    (21, 12, 10, 16, 8, False),    # V padded to the kernel's rank
    (13, 5, 24, 32, 13, True),     # padded, bf16 gather
])
def test_gather_syrk_seg_into_is_the_add_into_the_prior(r, w, k, kv, n_seg, bf16):
    """Bit for bit what `prec_all[ids] += alpha * prec` writes into
    buffers that hold the prior, at permuted items, the kept K x K block
    where V is padded; the items it does not cover are left as they were,
    and on the CPU nothing is launched."""
    rng = np.random.default_rng(r * 10 + w + k)
    idx, val, msk, seg = (_t(a) for a in _bucket(rng, r, w, 60, n_seg))
    v = _t(rng.normal(size=(60, k)).astype(np.float32))
    n_items = n_seg + 7
    ids = torch.as_tensor(rng.permutation(n_items)[:n_seg])
    lam, prior_rhs = _prior(rng, k)
    kw = dict(bf16_gather=bf16, identity_segments=n_seg == r,
              seg_ptr=torch.tensor(ops.segment_offsets(seg.numpy(), n_seg)))
    prec, rhs = ops.gather_syrk_seg(idx, val, msk, seg, n_seg, v, **kw)
    want_p = lam.expand(n_items, k, k).clone()
    want_r = prior_rhs.expand(n_items, k).clone()
    want_p[ids] += 1.5 * prec
    want_r[ids] += 1.5 * rhs
    got_p = torch.full((n_items, k, k), float("nan"))
    got_r = torch.full((n_items, k), float("nan"))
    ops.reset_launches()
    ops.gather_syrk_seg_into(idx, val, msk, seg, n_seg, ops.pad_rank(v, kv), got_p, got_r,
                             ids, lam, prior_rhs, 1.5, **kw)
    assert sum(ops.launches().values()) == 0
    assert torch.equal(got_p[ids], want_p[ids]) and torch.equal(got_r[ids], want_r[ids])
    rest = torch.ones(n_items, dtype=torch.bool)
    rest[ids] = False
    assert got_p[rest].isnan().all() and got_r[rest].isnan().all()


@pytest.mark.parametrize("case", ["stacked", "ids_short", "ids_int32", "rank_above_v",
                                  "dtype", "systems_shape"])
def test_gather_syrk_seg_into_raises_on_what_it_cannot_take(case):
    rng = np.random.default_rng(1)
    idx, val, msk, seg = (_t(a) for a in _bucket(rng, 8, 4, 20, 5))
    k = 16
    v = torch.zeros(20, k)
    prec_all, rhs_all = torch.zeros(9, k, k), torch.zeros(9, k)
    ids = torch.arange(5)
    lam, prior_rhs = _prior(rng, k)
    if case == "stacked":
        v = torch.zeros(2, 20, k)
    elif case == "ids_short":
        ids = ids[:4]
    elif case == "ids_int32":
        ids = ids.int()
    elif case == "rank_above_v":
        v = torch.zeros(20, 8)
    elif case == "dtype":
        prec_all = prec_all.double()
    else:
        rhs_all = torch.zeros(9, k + 1)
    with pytest.raises(ValueError):
        ops.gather_syrk_seg_into(idx, val, msk, seg, 5, v, prec_all, rhs_all, ids, lam,
                                 prior_rhs, 1.5, seg_ptr=torch.tensor(
                                     ops.segment_offsets(seg.numpy(), 5)))


def test_wrappers_do_not_count_cpu_calls():
    rng = np.random.default_rng(0)
    idx, val, msk, seg = _bucket(rng, 8, 8, 10, 4)
    ops.reset_launches()
    ops.gather_syrk_seg(_t(idx), _t(val), _t(msk), _t(seg), 4,
                        torch.randn(10, 8))  # repro-lint: disable=rng-global (values unused: the test counts launches)
    ops.masked_syrk(torch.randn(3, 4, 8), torch.randn(3, 4))  # repro-lint: disable=rng-global (values unused)
    ops.topn_scores(torch.randn(2, 8), torch.randn(9, 8), 3)  # repro-lint: disable=rng-global (values unused)
    assert set(ops.LAUNCHES.values()) == {0}


def test_segment_offsets_match_plan_boundaries():
    seg = np.array([0, 0, 1, 3, 3, 3], dtype=np.int32)
    assert ops.segment_offsets(seg, 4).tolist() == [0, 2, 3, 3, 6]


@pytest.mark.parametrize("r,w,k", [
    (8, 16, 8), (5, 33, 24), (1, 8, 64), (24, 128, 32),
    # ragged R and W, which the CUDA kernel now takes unpadded
    (1, 1, 16), (3, 2, 64), (483, 5, 32),
])
def test_masked_syrk_plain_matches_jax_kernel(r, w, k):
    rng = np.random.default_rng(r * 1000 + w + k)
    vm = rng.normal(size=(r, w, k)).astype(np.float32)
    rv = rng.normal(size=(r, w)).astype(np.float32)
    pj, bj = jops.masked_syrk(jnp.asarray(vm), jnp.asarray(rv))  # interpret mode
    pt, bt = ops.masked_syrk(_t(vm), _t(rv))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-4, atol=1e-3)
    # stacked leading axes flatten into rows
    p2, _ = ops.masked_syrk(_t(np.stack([vm, vm])), _t(np.stack([rv, rv])))
    np.testing.assert_array_equal(p2[1].numpy(), pt.numpy())


@pytest.mark.parametrize("b,k", [(16, 16), (7, 24), (1, 8), (20, 64),
                                 # batches the CUDA kernel takes as they are
                                 (3, 64), (21, 16)])
def test_chol_solve_sample_plain_matches_jax_kernel(b, k):
    rng = np.random.default_rng(b + k)
    a = rng.normal(size=(b, k, k))
    prec = (a @ np.transpose(a, (0, 2, 1)) + (k * 0.1 + 0.5) * np.eye(k)).astype(np.float32)
    rhs = rng.normal(size=(b, k)).astype(np.float32)
    z = rng.normal(size=(b, k)).astype(np.float32)
    xj = jops.chol_solve_sample(jnp.asarray(prec), jnp.asarray(rhs), jnp.asarray(z))
    xt = ops.chol_solve_sample(_t(prec), _t(rhs), _t(z))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=2e-3, atol=2e-3)
    # z = 0 solves the system
    x0 = ops.chol_solve_sample(_t(prec), _t(rhs), torch.zeros(b, k))
    recon = np.einsum("bij,bj->bi", prec, x0.numpy())
    np.testing.assert_allclose(recon, rhs, rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("b,k,cond", [(5, 64, 1e3), (9, 16, 1e3)])
def test_chol_solve_sample_plain_matches_jax_kernel_ill_conditioned(b, k, cond):
    """Systems Q diag(s) Q^T with s log-evenly over [1, cond]: the condition
    number the tests of the CUDA kernel reach."""
    rng = np.random.default_rng(b * k)
    q, _ = np.linalg.qr(rng.normal(size=(b, k, k)))
    sv = np.logspace(0, np.log10(cond), k)
    prec = (q * sv) @ np.transpose(q, (0, 2, 1))
    prec = (0.5 * (prec + np.transpose(prec, (0, 2, 1)))).astype(np.float32)
    rhs = rng.normal(size=(b, k)).astype(np.float32)
    z = rng.normal(size=(b, k)).astype(np.float32)
    xj = jops.chol_solve_sample(jnp.asarray(prec), jnp.asarray(rhs), jnp.asarray(z))
    xt = ops.chol_solve_sample(_t(prec), _t(rhs), _t(z))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=2e-3, atol=2e-3)


def test_chol_solve_sample_not_positive_definite_does_not_raise():
    """The clamp keeps the arithmetic going on a non-PD system, as in the
    reference kernel: same values, non-finite where the reference's are."""
    k = 8
    prec = np.stack([-np.eye(k), np.diag(np.r_[1.0, -2.0, np.ones(k - 2)]),
                     2 * np.eye(k)]).astype(np.float32)
    rhs = np.ones((3, k), np.float32)
    z = np.zeros((3, k), np.float32)
    xj = np.asarray(jops.chol_solve_sample(jnp.asarray(prec), jnp.asarray(rhs),
                                           jnp.asarray(z)))
    xt = ops.chol_solve_sample(_t(prec), _t(rhs), _t(z)).numpy()
    np.testing.assert_array_equal(np.isfinite(xt), np.isfinite(xj))
    fin = np.isfinite(xj)
    np.testing.assert_allclose(xt[fin], xj[fin], rtol=2e-3)
    np.testing.assert_allclose(xt[2], 0.5 * np.ones(k), rtol=1e-6)


@pytest.mark.parametrize("k", [8, 16, 64])
def test_chol_solve_sample_nan_mode_only_adds_nan_rows(k):
    """"nan" gives the clamp's bits on every system whose pivots are all
    > 0 and a row of NaN on each of the others (a negative pivot, a zero
    one, a NaN one); an unknown mode raises."""
    rng = np.random.default_rng(k)
    a = rng.normal(size=(6, k, k))
    prec = (a @ np.transpose(a, (0, 2, 1)) + k * np.eye(k)).astype(np.float32)
    prec[1, k // 2, k // 2] = -3.0
    prec[2] = np.eye(k)
    prec[2, k - 2:, k - 2:] = 1.0
    prec[3, 0, 0] = np.nan
    rhs, z = _t(rng.normal(size=(6, k)).astype(np.float32)), torch.ones(6, k)
    clamp = ops.chol_solve_sample(_t(prec), rhs, z)
    nan = ops.chol_solve_sample(_t(prec), rhs, z, indefinite="nan")
    good = torch.tensor([True, False, False, False, True, True])
    assert torch.equal(nan[good], clamp[good])
    assert torch.isnan(nan[~good]).all()
    with pytest.raises(ValueError, match="indefinite"):
        ops.chol_solve_sample(_t(prec), rhs, z, indefinite="raise")


def _dyadic(rng, shape):
    """Multiples of 1/8 in [-2, 2]: products and their sums are exact."""
    return (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)


@pytest.mark.parametrize("b,n,d,topk", [
    (8, 256, 16, 10), (5, 300, 64, 17), (16, 1000, 32, 128), (3, 50, 8, 50),
])
def test_topn_plain_matches_jax_kernel_with_ties(b, n, d, topk):
    rng = np.random.default_rng(b * n + topk)
    u = _dyadic(rng, (b, d))
    v = _dyadic(rng, (n, d))
    # plant exact ties: duplicated item rows, including across the kernel's
    # 128-item tiles
    v[7] = v[3]
    v[n - 1] = v[3]
    v[min(130, n - 2)] = v[3]
    vj, ij = jops.topn_scores(jnp.asarray(u), jnp.asarray(v), topk)
    vt, it = ops.topn_scores(_t(u), _t(v), topk)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_topn_plain_random_matches_jax_kernel():
    rng = np.random.default_rng(4)
    u = rng.normal(size=(12, 64)).astype(np.float32)
    v = rng.normal(size=(333, 64)).astype(np.float32)
    vj, ij = jops.topn_scores(jnp.asarray(u), jnp.asarray(v), 20)
    vt, it = ops.topn_scores(_t(u), _t(v), 20)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5, atol=1e-5)


def test_topn_rejects_bad_topk():
    with pytest.raises(ValueError):
        ops.topn_scores(torch.zeros(2, 4), torch.zeros(3, 4), 4)


# ---------------------------------------------------------------------------
# the ranks the kernels take: padding helpers, through the plain versions
# ---------------------------------------------------------------------------
def test_kernel_rank_rounds_up_to_an_instantiated_rank():
    assert [ops.kernel_rank(k) for k in (1, 8, 16, 17, 24, 32, 40, 64)] == [
        16, 16, 16, 32, 32, 32, 64, 64]
    assert ops.KERNEL_RANKS == (16, 32, 64)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        ops.kernel_rank(65)


@pytest.mark.parametrize("k", [8, 24, 40])
def test_zero_padded_syrk_keeps_the_block_bit_for_bit(k):
    """Zero columns add exact zeros: the kept K x K block and K-vector of
    the padded statistics are the unpadded ones, bit for bit, and the
    padded rows and columns are zero. (The plain versions sum each entry
    on its own, over W in order, as the kernels do.)"""
    kp = ops.kernel_rank(k)
    rng = np.random.default_rng(k)
    vm = _t(rng.normal(size=(6, 40, k)).astype(np.float32))
    rv = _t(rng.normal(size=(6, 40)).astype(np.float32))
    pp, bp = ops.masked_syrk(ops.pad_rank(vm, kp), rv)
    pu, bu = ops.masked_syrk(vm, rv)
    assert pp.shape == (6, kp, kp) and pp.dtype == torch.float32
    assert torch.equal(pp[:, :k, :k], pu) and torch.equal(bp[:, :k], bu)
    assert not pp[:, k:].any() and not pp[:, :, k:].any() and not bp[:, k:].any()
    # the fused statistics over a zero-padded V, stacked draws included
    idx, val, msk, seg = _bucket(rng, 12, 16, 30, 5)
    v = _t(rng.normal(size=(2, 30, k)).astype(np.float32))
    args = (_t(idx), _t(val), _t(msk), _t(seg), 5)
    for bf16 in (False, True):
        gp, hp = ops.gather_syrk_seg(*args, ops.pad_rank(v, kp), bf16_gather=bf16)
        gu, hu = ops.gather_syrk_seg(*args, v, bf16_gather=bf16)
        assert gp.shape == (2, 5, kp, kp)
        assert torch.equal(gp[..., :k, :k], gu) and torch.equal(hp[..., :k], hu)
        assert not gp[..., k:, :].any() and not hp[..., k:].any()


def _spd(rng, b, k):
    a = rng.normal(size=(b, k, k))
    return (a @ np.transpose(a, (0, 2, 1)) + (k * 0.1 + 0.5) * np.eye(k)).astype(np.float32)


@pytest.mark.parametrize("k", [8, 24, 40])
def test_identity_padded_solve_matches_the_unpadded_solve(k):
    kp = ops.kernel_rank(k)
    rng = np.random.default_rng(100 + k)
    prec, rhs, z = (_t(_spd(rng, 9, k)), _t(rng.normal(size=(9, k)).astype(np.float32)),
                    _t(rng.normal(size=(9, k)).astype(np.float32)))
    big, rhs_p, z_p = ops.pad_rank_systems(prec, rhs, z, kp)
    assert big.shape == (9, kp, kp) and rhs_p.shape == z_p.shape == (9, kp)
    assert torch.equal(big[:, :k, :k], prec)
    assert torch.equal(big[:, k:, k:], torch.eye(kp - k).expand(9, -1, -1))
    assert not big[:, :k, k:].any() and not big[:, k:, :k].any()
    xp = ops.chol_solve_sample(big, rhs_p, z_p)
    xu = ops.chol_solve_sample(prec, rhs, z)
    np.testing.assert_allclose(xp[:, :k].numpy(), xu.numpy(), rtol=1e-6, atol=1e-6)
    assert not xp[:, k:].any()


@pytest.mark.parametrize("k", [8, 24])
def test_padded_plain_versions_match_jax_kernels(k):
    """The statistics and the solve at the kernels' padded rank, cut back
    to K, against the JAX kernels at K itself."""
    kp = ops.kernel_rank(k)
    rng = np.random.default_rng(200 + k)
    vm = rng.normal(size=(7, 24, k)).astype(np.float32)
    rv = rng.normal(size=(7, 24)).astype(np.float32)
    pj, bj = jops.masked_syrk(jnp.asarray(vm), jnp.asarray(rv))  # interpret mode
    pt, bt = ops.masked_syrk(ops.pad_rank(_t(vm), kp), _t(rv))
    np.testing.assert_allclose(pt[:, :k, :k].numpy(), np.asarray(pj), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(bt[:, :k].numpy(), np.asarray(bj), rtol=1e-4, atol=1e-3)

    idx, val, msk, seg = _bucket(rng, 10, 16, 40, 6)
    v = rng.normal(size=(40, k)).astype(np.float32)
    gj, hj = jops.gather_syrk_seg(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(msk),
                                  jnp.asarray(seg), 6, jnp.asarray(v), interpret=None)
    gt, ht = ops.gather_syrk_seg(_t(idx), _t(val), _t(msk), _t(seg), 6,
                                 ops.pad_rank(_t(v), kp))
    np.testing.assert_allclose(gt[:, :k, :k].numpy(), np.asarray(gj), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(ht[:, :k].numpy(), np.asarray(hj), rtol=1e-4, atol=1e-3)

    prec = _spd(rng, 5, k)
    rhs = rng.normal(size=(5, k)).astype(np.float32)
    z = rng.normal(size=(5, k)).astype(np.float32)
    xj = jops.chol_solve_sample(jnp.asarray(prec), jnp.asarray(rhs), jnp.asarray(z))
    xt = ops.chol_solve_sample(*ops.pad_rank_systems(_t(prec), _t(rhs), _t(z), kp))
    np.testing.assert_allclose(xt[:, :k].numpy(), np.asarray(xj), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("b,n,d", [(5, 300, 6), (130, 129, 16), (1, 1, 1), (3, 40, 2)])
def test_topn_operands_pad_the_width_with_zero_columns(b, n, d):
    """The scoring kernel's operands: the width padded to a multiple of 4,
    and no score changed by it: the plain top-N of the padded operands is
    the unpadded one, bit for bit."""
    rng = np.random.default_rng(b + n + d)
    u = _t(rng.normal(size=(b, d)).astype(np.float32))
    v = _t(rng.normal(size=(n, d)).astype(np.float32))
    up, vp = ops.topn_operands(u, v)
    dp = -(-d // 4) * 4
    assert up.shape == (b, dp) and vp.shape == (n, dp)
    assert torch.equal(up[:, :d], u) and torch.equal(vp[:, :d], v)
    assert not up[:, d:].any() and not vp[:, d:].any()
    k = min(n, 7)
    vals_p, idx_p = ops.topn_scores(up, vp, k)
    vals_u, idx_u = ops.topn_scores(u, v, k)
    assert torch.equal(vals_p, vals_u) and torch.equal(idx_p, idx_u)
    if d % 4 == 0:
        assert up.data_ptr() == u.data_ptr()      # no copy


@pytest.mark.parametrize("b", [1, 4096, 10 ** 6])
@pytest.mark.parametrize("topk", [1, 1024, ops.TOPN_MAX_K])
def test_topn_scratch_is_bounded_whatever_the_catalogue(b, topk):
    """Slabs: whole tiles, their (B, slab) scores within the scratch bound
    (or one tile), a row's slab scores beside the keys in a selection
    block, whatever the catalogue's size."""
    keys = 8 << (topk - 1).bit_length()
    for n in (topk, 5775, 10 ** 6, 10 ** 9):
        slab = ops.topn_slab(b, n, topk)
        assert slab % 128 == 0 and 128 <= slab <= -(-n // 128) * 128
        assert b * slab * 4 <= max(ops.TOPN_SCRATCH_BYTES, b * 128 * 4)
        assert keys + 4 * slab <= ops.TOPN_SELECT_SMEM
        assert ops.topn_kernel_launches(b, n, topk) == 2 * -(-n // slab)
    assert ops.topn_slab(4096, 5775, 1024) == 5888          # one slab: the ChEMBL catalogue
    assert ops.topn_slab(4096, 5775, 1024, slab=300) == 384  # a test's smaller slabs


def test_three_bf16_terms_carry_an_fp32_p_exactly():
    """The premise of the bf16 flash kernel's P V (csrc/flash_attention.cu):
    an fp32 p in [2^-100, 1] is the exact sum of three bf16 terms
    p1 = bf16(p), p2 = bf16(p - p1), p3 = bf16(p - p1 - p2), each remainder
    exact in fp32; each term times a bf16 v is exact in fp32; and two terms
    are not enough. torch rounds to bf16 to nearest even, as the kernel's
    __floats2bfloat162_rn does."""
    rng = np.random.default_rng(17)
    p = np.concatenate([
        np.exp2(rng.uniform(-100, 0, 1 << 20)),   # every binade of the range
        np.exp(rng.uniform(-30, 0, 1 << 20)),     # softmax weights
        [1.0, 2.0 ** -100, 0.5 + 2.0 ** -24],
    ]).astype(np.float32)
    t = torch.from_numpy(p)
    p1 = t.to(torch.bfloat16)
    r1 = t - p1.float()
    p2 = r1.to(torch.bfloat16)
    r2 = r1 - p2.float()
    p3 = r2.to(torch.bfloat16)
    exact = t.double()
    assert torch.equal(r1.double(), exact - p1.double())            # remainders exact
    assert torch.equal(r2.double(), r1.double() - p2.double())
    assert torch.equal(p3.float(), r2)                               # p3 holds the rest
    assert torch.equal(p1.double() + p2.double() + p3.double(), exact)
    two = p1.double() + p2.double()
    assert not torch.equal(two, exact)
    rel = float(((two - exact).abs() / exact).max())
    assert 0 < rel <= 2.0 ** -16
    v = torch.from_numpy(rng.standard_normal(len(p)).astype(np.float32) * 8).to(torch.bfloat16)
    for term in (p1, p2, p3):
        assert torch.equal((term.float() * v.float()).double(), term.double() * v.double())


def _three_bf16_terms(t):
    """(x1, x2, x3, r1, r2) of the kernels' split3, in torch on the CPU."""
    x1 = t.to(torch.bfloat16)
    r1 = t - x1.float()
    x2 = r1.to(torch.bfloat16)
    r2 = r1 - x2.float()
    return x1, x2, r2.to(torch.bfloat16), r1, r2


def test_three_bf16_terms_carry_a_signed_fp32_ds_exactly():
    """The premise of the bf16 flash backward's dV, dQ and dK
    (csrc/flash_attention_bwd.cu): P and dS enter the MMAs as three bf16
    terms, and dS is signed and of any magnitude. Every fp32 x with
    2^-100 <= |x| < 2^60, of either sign, is the exact sum x1 + x2 + x3
    (24 significant bits, 8 a term; the last term's bits stay above bf16's
    subnormals): checked on every binade of that range and on values shaped
    like dS, scale P (dP - D) (1 - t^2) from seeded draws at the training
    step's head width. Each term times a bf16 operand (magnitudes 2^-8 to
    2^8, as q, k and dO hold) is exact in fp32, and two terms leave up to
    2^-16 of x. Below the range the split stays exact down to 2^-110; under
    that the last term falls among bf16's subnormals and up to 2^-134 of x
    is lost, far under the 1e-5 floor of the gradients' checks."""
    rng = np.random.default_rng(23)
    n = 1 << 18
    sign = rng.choice([-1.0, 1.0], n)
    binades = sign * np.exp2(rng.uniform(-100, 60, n))
    # dS-shaped: scores and dP of a 256-wide head, its softcap of 50
    d, scale, cap = 256, 256 ** -0.5, 50.0
    s = (rng.standard_normal(n) * 16.0).astype(np.float32)
    t = np.tanh(s * np.float32(scale) / np.float32(cap)).astype(np.float32)
    p = np.exp(t * np.float32(cap) - np.float32(np.log(d))).astype(np.float32)
    dp = (rng.standard_normal(n) * np.sqrt(d)).astype(np.float32)
    delta = rng.standard_normal(n).astype(np.float32)
    ds = (np.float32(scale) * p * (dp - delta) * (np.float32(1) - t * t)).astype(np.float32)
    x = np.concatenate([binades, ds[ds != 0],
                        [2.0 ** -100, -(2.0 ** -100), 2.0 ** 60 - 2.0 ** 36,
                         -(1.0 + 2.0 ** -23)]]).astype(np.float32)
    tx = torch.from_numpy(x)
    x1, x2, x3, r1, r2 = _three_bf16_terms(tx)
    exact = tx.double()
    assert torch.equal(r1.double(), exact - x1.double())            # remainders exact
    assert torch.equal(r2.double(), r1.double() - x2.double())
    assert torch.equal(x3.float(), r2)                               # x3 holds the rest
    assert torch.equal(x1.double() + x2.double() + x3.double(), exact)
    two = x1.double() + x2.double()
    assert not torch.equal(two, exact)
    assert 0 < float(((two - exact).abs() / exact.abs()).max()) <= 2.0 ** -16
    mag = np.exp2(np.round(rng.uniform(-8, 8, len(x)) * 8) / 8)
    v = torch.from_numpy((rng.choice([-1.0, 1.0], len(x)) * mag).astype(np.float32))
    v = v.to(torch.bfloat16)
    for term in (x1, x2, x3):
        assert torch.equal((term.float() * v.float()).double(), term.double() * v.double())
    # below the range: exact to 2^-110, then at most 2^-134 lost
    for lo, hi, lost in ((-110, -100, 0.0), (-126, -110, 2.0 ** -134)):
        y = torch.from_numpy((sign * np.exp2(rng.uniform(lo, hi, n))).astype(np.float32))
        y1, y2, y3, _, _ = _three_bf16_terms(y)
        err = float((y.double() - (y1.double() + y2.double() + y3.double())).abs().max())
        assert err <= lost and (lost == 0.0 or err > 0.0), (lo, hi, err)


# ---------------------------------------------------------------------------
# the flash pair's query offset (a shard of a sequence's queries)
# ---------------------------------------------------------------------------
FLASH_OFFSET_CASES = [  # causal, window, softcap
    (True, 0, 0.0), (True, 24, 50.0), (True, 40, 0.0), (False, 0, 30.0)]


@pytest.mark.parametrize("causal,window,cap", FLASH_OFFSET_CASES)
@pytest.mark.parametrize("offset", [0, 16, 37, 48])
def test_flash_offset_plain_version_matches_jax(offset, causal, window, cap):
    """The plain forward of 16 queries at `offset` over 64 keys (GQA 2)
    against the JAX package's direct multi_head_attention(q_offset=) at the
    flash tolerance (rtol/atol 5e-4, tests/test_torch_lm.py's), and the
    model's flash branch (`chunk`) on the same shard."""
    from repro.models import layers as jl
    from repro_torch.kernels import ref
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(offset)
    q = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 64, 2, 32)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    want = np.asarray(jl.multi_head_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                              q_offset=offset, **kw))
    flat = [torch.tensor(x).transpose(1, 2).reshape(-1, x.shape[1], 32) for x in (q, k, v)]
    got = ref.flash_attention_ref(*flat, causal=causal, window=window, softcap=cap,
                                  q_offset=offset)
    got = got.reshape(2, 4, 16, 32).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)
    if causal and offset + 16 > 64:
        return
    branch = tl.multi_head_attention(*(torch.tensor(x) for x in (q, k, v)), chunk=16,
                                     q_offset=offset, **kw)
    np.testing.assert_allclose(branch.numpy(), want, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("causal,window,cap", FLASH_OFFSET_CASES)
def test_flash_offset_shards_join_to_the_whole(causal, window, cap):
    """Four shards of 16 queries at offsets 0, 16, 32, 48 over the same 64
    keys: the plain forward's rows, lse and dQ joined are the whole
    launch's bits, and dK, dV summed over the shards its sums within 1e-6
    of their largest magnitude (summed in another order)."""
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(7)
    q = torch.randn(4, 64, 32, generator=g)
    k, v = (torch.randn(2, 64, 32, generator=g) for _ in range(2))
    do = torch.randn(4, 64, 32, generator=g)
    kw = dict(causal=causal, window=window, softcap=cap, scale=0.2)
    out, lse, o = ref.flash_attention_fwd_ref(q, k, v, **kw)
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, do, lse, o, **kw)
    parts = []
    for i in range(4):
        sl = slice(16 * i, 16 * (i + 1))
        po, pl, pf = ref.flash_attention_fwd_ref(q[:, sl], k, v, q_offset=16 * i, **kw)
        parts.append((po, pl) + ref.flash_attention_bwd_ref(q[:, sl], k, v, do[:, sl], pl, pf,
                                                            q_offset=16 * i, **kw))
    assert torch.equal(torch.cat([p[0] for p in parts], 1), out)
    assert torch.equal(torch.cat([p[1] for p in parts], 1), lse)
    assert torch.equal(torch.cat([p[2] for p in parts], 1), dq)
    for want, got in ((dk, sum(p[3] for p in parts)), (dv, sum(p[4] for p in parts))):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("sk,window", [(64, 0), (64, 24), (8192, 4096), (1500, 0)])
@pytest.mark.parametrize("n_shards", [1, 4, 16])
def test_visible_pairs_of_the_shards_sum_to_the_whole(sk, window, n_shards):
    """The flops each shard's launch counts add up to the whole launch's,
    causal; without causality every shard sees every key."""
    n = sk // n_shards
    whole = ops.visible_pairs(n * n_shards, sk, window=window)
    assert sum(ops.visible_pairs(n, sk, window=window, q_offset=i * n)
               for i in range(n_shards)) == whole
    assert ops.visible_pairs(n, sk, causal=False, q_offset=n) == n * sk
    want = sum(min(q + 1, sk, window or sk) for q in range(n * (n_shards - 1), n * n_shards))
    assert ops.visible_pairs(n, sk, window=window, q_offset=n * (n_shards - 1)) == want


def test_flash_ops_take_dtensors_sharded_on_batch_heads():
    """The flash pair's DTensor rule: Q, K, V sharded on their batch-heads
    dim run each rank's heads and keep that sharding (on the meta device,
    in a fake world of 4 ranks); a negative offset raises."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.launch.mesh import fake_world

    meta = torch.device("meta")
    q = torch.empty(8, 64, 32, device=meta)
    kv = torch.empty(4, 64, 32, device=meta)
    with fake_world(4):
        m = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        dq, dk = (distribute_tensor(t, m, [Shard(0)]) for t in (q, kv))
        out, lse, o32 = ops.flash_forward(dq, dk, dk, True, 0, 0.0, 0.1, True, 16)
        assert [t.placements for t in (out, lse)] == [(Shard(0),), (Shard(0),)]
        assert out.to_local().shape == (2, 64, 32) and lse.to_local().shape == (2, 64)
        grads = ops.flash_attention_bwd(dq, dk, dk, out, lse, out, causal=True, window=0,
                                        softcap=0.0, scale=0.1, q_offset=16)
        assert [g.placements for g in grads] == [(Shard(0),)] * 3
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_forward(q, kv, kv, True, 0, 0.0, 0.1, True, -1)
