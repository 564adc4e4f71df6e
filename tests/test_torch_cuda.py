"""Each CUDA kernel against its plain PyTorch version on the card.

These tests need an NVIDIA GPU with nvcc (the kernels have no CPU mode):
they carry the `cuda` marker and skip without a card. This file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances, and why:
  * gather_syrk_seg: equal bit for bit. Kernel and plain version both sum
    each row over W in order in fp64, then each segment's rows in row
    order in fp64, and round once; against a float64 evaluation the
    kernel's error is at most the plain version's.
  * gather_syrk_seg_into: equal bit for bit to the plain kernel's sums
    scaled and added into buffers that hold the prior: the same two fp32
    roundings an entry, no fused multiply-add.
  * masked_syrk: equal bit for bit. Every entry is the fp32 rounding of
    an in-order fp64 sum of exact products, in the kernel (either path)
    and in its plain version.
  * chol_solve_sample: rtol 2e-3, atol 2e-3 (tests/test_kernels.py:56).
  * topn_scores: equal bit for bit; kernel and plain version sum the
    products in the same order with the same roundings.
  * flash_attention: 3e-4 in fp32 and 3e-2 in bf16, the JAX kernel tests'
    own (tests/test_kernels.py:88, 91); both sum in fp32 in another order.
    Its backward: each gradient within one bf16 ulp of its largest
    magnitude of the float64 plain version (3e-4 of it in fp32), as
    chip_smoke.py holds it at the training step's shapes (`_grads_hold`);
    bf16 runs its products on the tensor cores, P and dS split into three
    bf16 terms, fp32 on the fp32 pipes, whose bits are held to a digest.
    3e-2 is as large as the outputs of N(0,1) inputs over long sequences,
    so bf16 results are also held to one bf16 ulp of the value (rtol
    2^-7, atol 1e-5): kernel and plain version both compute in fp32 and
    round the output to bf16 once. The bf16 kernel runs both products on
    the tensor cores, P split into three bf16 terms that sum to it
    exactly. The peaked cases (q x 6, q x 16) make the softcap and each
    key count.

The BPMF kernels are instantiated for K = 16, 32 and 64; the cases run
every rank the repo uses (8, 16, 24, 32, 64), the others through the
wrappers' padding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest-xdist runs several workers on the same cores,
# and torch's default thread count each would oversubscribe them
torch.set_num_threads(1)

from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bucket(rng, r, w, n, n_seg, device):
    idx = rng.integers(0, n, (r, w)).astype(np.int32)
    val = rng.normal(size=(r, w)).astype(np.float32)
    msk = (rng.random((r, w)) > 0.3).astype(np.float32)
    extra = np.sort(rng.integers(0, n_seg, r - n_seg))
    seg = np.sort(np.concatenate([np.arange(n_seg), extra])).astype(np.int32)
    return [torch.tensor(a, device=device) for a in (idx, val, msk, seg)]


RANKS = [8, 16, 24, 32, 64]


@pytest.mark.parametrize("k", RANKS)
@pytest.mark.parametrize("r,w,n_seg,s,bf16", [
    (40, 512, 7, 0, False),    # long segments: the two-pass path
    (64, 3, 64, 0, False),     # identity segments: one pass
    (33, 100, 12, 4, True),    # stacked draws, bf16 gather
    (19, 70, 19, 3, False),    # stacked identity, padded rows
])
def test_gather_syrk_seg_kernel_matches_plain(cuda, r, w, n_seg, s, bf16, k):
    rng = np.random.default_rng(r + w)
    args = _bucket(rng, r, w, 500, n_seg, cuda)
    v = torch.tensor(rng.normal(size=((s,) if s else ()) + (500, k)).astype(np.float32),
                     device=cuda)
    kw = dict(bf16_gather=bf16, identity_segments=n_seg == r)
    seg_ptr = torch.tensor(ops.segment_offsets(args[3].cpu().numpy(), n_seg), device=cuda)
    ops.reset_launches()
    pk, bk = ops.gather_syrk_seg(*args, n_seg, v, seg_ptr=seg_ptr, **kw)
    assert ops.LAUNCHES["gather_syrk_seg"] == 1
    pp, bp = ref.gather_syrk_seg_ref(*args, n_seg, v, **kw)
    assert pk.shape == pp.shape and bk.shape == bp.shape
    assert torch.equal(pk, pp) and torch.equal(bk, bp)
    if not bf16:
        idx, val, msk, seg = args
        p64, _ = ref.gather_syrk_seg_ref(idx, val.double(), msk.double(), seg, n_seg,
                                         v.double(), **kw)
        assert (pk.double() - p64).abs().max() <= (pp.double() - p64).abs().max()


# the widths gather_syrk_seg takes unpadded: both sides of the narrow
# path's threshold (ops.SYRK_NARROW_MAX_W) and of the row blocks' 32-vector
# chunks, and the widest ChEMBL bucket
SEG_WIDTHS = [1, 3, 7, 9, 18, 19, 33, 129, 512]


@pytest.mark.parametrize("k", RANKS)
@pytest.mark.parametrize("w", SEG_WIDTHS)
@pytest.mark.parametrize("r,n_seg,s,bf16", [
    (13, 13, 0, False),     # identity segments, R no multiple of 8
    (21, 6, 0, False),      # multi-row segments
    (13, 13, 3, False),     # 3 stacked draws
    (21, 6, 3, True),       # ... of multi-row segments, bf16 gather
])
def test_gather_syrk_seg_kernel_is_bit_equal_to_plain(cuda, r, n_seg, s, bf16, w, k):
    rng = np.random.default_rng(r * 1000 + w + k)
    args = _bucket(rng, r, w, 300, n_seg, cuda)
    v = torch.tensor(rng.normal(size=((s,) if s else ()) + (300, k)).astype(np.float32),
                     device=cuda)
    kw = dict(bf16_gather=bf16, identity_segments=n_seg == r)
    seg_ptr = torch.tensor(ops.segment_offsets(args[3].cpu().numpy(), n_seg), device=cuda)
    ops.reset_launches()
    pk, bk = ops.gather_syrk_seg(*args, n_seg, v, seg_ptr=seg_ptr, **kw)
    assert ops.LAUNCHES["gather_syrk_seg"] == 1
    pp, bp = ref.gather_syrk_seg_ref(*args, n_seg, v, **kw)
    assert pk.shape == pp.shape == ((s,) if s else ()) + (n_seg, k, k)
    assert torch.equal(pk, pp) and torch.equal(bk, bp)


@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("w", [3, 33])
def test_gather_syrk_seg_kernel_fractional_mask_bit_equal(cuda, w, k):
    """A mask other than 0 and 1 (the plain version rounds g m and c m to
    fp32 before the products): both paths, identity and multi-row."""
    rng = np.random.default_rng(w + k)
    for r, n_seg in ((13, 13), (21, 6)):
        idx, val, msk, seg = _bucket(rng, r, w, 300, n_seg, cuda)
        msk = msk * torch.tensor(rng.uniform(0.1, 1.7, (r, w)).astype(np.float32),
                                 device=cuda)
        v = torch.tensor(rng.normal(size=(300, k)).astype(np.float32), device=cuda)
        kw = dict(identity_segments=n_seg == r)
        seg_ptr = torch.tensor(ops.segment_offsets(seg.cpu().numpy(), n_seg), device=cuda)
        pk, bk = ops.gather_syrk_seg(idx, val, msk, seg, n_seg, v, seg_ptr=seg_ptr, **kw)
        pp, bp = ref.gather_syrk_seg_ref(idx, val, msk, seg, n_seg, v, **kw)
        assert torch.equal(pk, pp) and torch.equal(bk, bp)


# the "into" store, with which the fused sweep writes its systems: the
# narrow path, wide identity rows, multi-row segments at a narrow and a
# wide width
INTO_BUCKETS = [(13, 5, 13), (13, 33, 13), (21, 33, 6), (21, 3, 6)]


@pytest.mark.parametrize("k", [16, 32, 64])
@pytest.mark.parametrize("r,w,n_seg", INTO_BUCKETS)
@pytest.mark.parametrize("padded,bf16", [(False, False), (True, False), (False, True)])
def test_gather_syrk_seg_into_kernel_is_the_kernel_plus_the_adds(cuda, k, r, w, n_seg,
                                                                 padded, bf16):
    """One launch writes, at each segment's item, the bits of today's
    kernel's statistics scaled and added into buffers that hold the prior
    (`prec_all[ids] += alpha * prec`), at permuted items, at the kernel's
    rank and at a rank 6 below it that the wrapper pads (the scalar
    stores); the 9 items no segment covers keep what they held, and the
    plain version on the card writes the same bits."""
    rng = np.random.default_rng(r * 100 + w + k)
    args = _bucket(rng, r, w, 300, n_seg, cuda)
    kt = k - 6 if padded else k
    v = torch.tensor(rng.normal(size=(300, kt)).astype(np.float32), device=cuda)
    n_items = n_seg + 9
    ids = torch.tensor(rng.permutation(n_items)[:n_seg], device=cuda)
    a = rng.normal(size=(kt, kt)).astype(np.float32)
    lam = torch.tensor(a @ a.T + kt * np.eye(kt, dtype=np.float32), device=cuda)
    prior_rhs = lam @ torch.tensor(rng.normal(size=kt).astype(np.float32), device=cuda)
    seg_ptr = torch.tensor(ops.segment_offsets(args[3].cpu().numpy(), n_seg), device=cuda)
    kw = dict(bf16_gather=bf16, identity_segments=n_seg == r)
    prec, rhs = ops.gather_syrk_seg(*args, n_seg, v, seg_ptr=seg_ptr, **kw)
    want_p = lam.expand(n_items, kt, kt).clone()
    want_r = prior_rhs.expand(n_items, kt).clone()
    want_p[ids] += 1.5 * prec
    want_r[ids] += 1.5 * rhs
    outs = []
    for fn in (ops.gather_syrk_seg_into, ref.gather_syrk_seg_into_ref):
        got_p = torch.full((n_items, kt, kt), float("nan"), device=cuda)
        got_r = torch.full((n_items, kt), float("nan"), device=cuda)
        ops.reset_launches()
        extra = dict(seg_ptr=seg_ptr) if fn is ops.gather_syrk_seg_into else {}
        fn(*args, n_seg, v, got_p, got_r, ids, lam, prior_rhs, 1.5, **kw, **extra)
        assert ops.launches()["gather_syrk_seg"] == (fn is ops.gather_syrk_seg_into)
        outs.append((got_p, got_r))
    (got_p, got_r), (plain_p, plain_r) = outs
    assert torch.equal(got_p[ids], want_p[ids]) and torch.equal(got_r[ids], want_r[ids])
    assert torch.equal(plain_p[ids], got_p[ids]) and torch.equal(plain_r[ids], got_r[ids])
    rest = torch.ones(n_items, dtype=torch.bool, device=cuda)
    rest[ids] = False
    assert got_p[rest].isnan().all() and got_r[rest].isnan().all()


def test_gather_syrk_seg_into_raises_on_the_card(cuda):
    """Stacked draws, buffers or ids on another device or of another
    type, ids of another length: raised before any launch."""
    idx, val, msk, seg = _bucket(np.random.default_rng(0), 8, 8, 10, 4, cuda)
    ptr = torch.tensor(ops.segment_offsets(seg.cpu().numpy(), 4), device=cuda)
    v = torch.zeros(10, 64, device=cuda)
    bufs = dict(prec_all=torch.zeros(6, 64, 64, device=cuda),
                rhs_all=torch.zeros(6, 64, device=cuda),
                item_ids=torch.arange(4, device=cuda), lam=torch.eye(64, device=cuda),
                prior_rhs=torch.zeros(64, device=cuda))
    bad = [dict(v=torch.zeros(2, 10, 64, device=cuda)), dict(item_ids=torch.arange(4)),
           dict(item_ids=torch.arange(3, device=cuda)),
           dict(item_ids=torch.arange(4, device=cuda, dtype=torch.int32)),
           dict(prec_all=torch.zeros(6, 64, 64)), dict(lam=torch.eye(64, device=cuda).double())]
    ops.reset_launches()
    for change in bad:
        a = {**bufs, "v": v, **change}
        with pytest.raises(ValueError):
            ops.gather_syrk_seg_into(idx, val, msk, seg, 4, a["v"], a["prec_all"], a["rhs_all"],
                                     a["item_ids"], a["lam"], a["prior_rhs"], 1.5, seg_ptr=ptr)
    assert sum(ops.launches().values()) == 0


def test_wrappers_raise_on_cuda_tensors_they_cannot_take(cuda):
    """No fallback: a CUDA tensor the kernel cannot take raises."""
    vm = torch.zeros(4, 8, 72, device=cuda)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        ops.masked_syrk(vm, torch.zeros(4, 8, device=cuda))          # K > 64
    prec = torch.eye(64, device=cuda).expand(3, 64, 64).double()
    with pytest.raises(ValueError):
        ops.chol_solve_sample(prec, torch.zeros(3, 64, device=cuda),
                              torch.zeros(3, 64, device=cuda))       # float64
    with pytest.raises(ValueError):
        ops.topn_scores(torch.zeros(2, 64, device=cuda), torch.zeros(9, 64), 3)
    idx, val, msk, seg = _bucket(np.random.default_rng(0), 8, 8, 10, 4, cuda)
    with pytest.raises(ValueError):                                   # no seg_ptr
        ops.gather_syrk_seg(idx, val, msk, seg, 4, torch.zeros(10, 64, device=cuda))


@pytest.mark.parametrize("k", RANKS)
def test_masked_syrk_and_chol_kernels_match_plain(cuda, k):
    g = torch.Generator(device=cuda).manual_seed(0)
    vm = torch.randn(50, 70, k, generator=g, device=cuda)
    rv = torch.randn(50, 70, generator=g, device=cuda)
    ops.reset_launches()
    for a, b in zip(ops.masked_syrk(vm, rv), ref.masked_syrk_ref(vm, rv)):
        assert a.shape == b.shape
        assert torch.equal(a, b)
    a = torch.randn(37, k, k, generator=g, device=cuda)
    prec = a @ a.transpose(1, 2) + (0.1 * k + 0.6) * torch.eye(k, device=cuda)
    rhs = torch.randn(37, k, generator=g, device=cuda)
    z = torch.randn(37, k, generator=g, device=cuda)
    x = ops.chol_solve_sample(prec, rhs, z)
    assert x.shape == (37, k)
    torch.testing.assert_close(x, ref.chol_solve_sample_ref(prec, rhs, z),
                               rtol=2e-3, atol=2e-3)
    assert ops.LAUNCHES["masked_syrk"] == ops.LAUNCHES["chol_solve_sample"] == 1


# the widths and row counts masked_syrk takes unpadded: narrow rows (one
# and a few vectors), both sides of the narrow path's threshold
# (ops.SYRK_NARROW_MAX_W) and of the wide path's 32-vector chunks, the
# widest ChEMBL bucket; rows that are no multiple of 8
SYRK_WIDTHS = [1, 2, 3, 7, 9, 31, 33, 64, 65, 127, 129, 1481]


def _syrk_block(g, lead, w, k, device):
    """A pre-gathered, pre-masked block: about a third of the vectors
    masked to zero, as the kernel engine's blocks are."""
    vm = torch.randn(*lead, w, k, generator=g, device=device)
    rv = torch.randn(*lead, w, generator=g, device=device)
    keep = (torch.rand(*lead, w, generator=g, device=device) > 0.3).float()
    return vm * keep[..., None], rv * keep


@pytest.mark.parametrize("k", RANKS)
@pytest.mark.parametrize("w", SYRK_WIDTHS)
@pytest.mark.parametrize("r", [1, 5, 483])
def test_masked_syrk_kernel_is_bit_equal_to_plain(cuda, r, w, k):
    g = torch.Generator(device=cuda).manual_seed(r * 10_000 + w * 100 + k)
    vm, rv = _syrk_block(g, (r,), w, k, cuda)
    ops.reset_launches()
    pk, bk = ops.masked_syrk(vm, rv)
    assert ops.LAUNCHES["masked_syrk"] == 1
    pp, bp = ref.masked_syrk_ref(vm, rv)
    assert pk.shape == (r, k, k) and bk.shape == (r, k)
    assert torch.equal(pk, pp) and torch.equal(bk, bp)


@pytest.mark.parametrize("k", RANKS)
@pytest.mark.parametrize("s,r,w", [(3, 5, 9), (4, 483, 2), (2, 7, 129)])
def test_masked_syrk_kernel_stacked_draws_bit_equal(cuda, s, r, w, k):
    """The kernel engine's stacked-draw input (S, R, W, K): one launch over
    S * R rows, each the same bits as the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(s + r + w + k)
    vm, rv = _syrk_block(g, (s, r), w, k, cuda)
    ops.reset_launches()
    pk, bk = ops.masked_syrk(vm, rv)
    assert ops.LAUNCHES["masked_syrk"] == 1 and pk.shape == (s, r, k, k)
    for i in range(s):
        pp, bp = ref.masked_syrk_ref(vm[i], rv[i])
        assert torch.equal(pk[i], pp) and torch.equal(bk[i], bp)


def test_masked_syrk_kernel_takes_a_block_off_16_bytes(cuda):
    """A block whose data starts 4 bytes into its storage (the kernel's
    16-byte copies need a copy of it), and one of width 0."""
    g = torch.Generator(device=cuda).manual_seed(5)
    buf = torch.randn(1 + 11 * 6 * 64, generator=g, device=cuda)
    vm = buf[1:].view(11, 6, 64)
    assert vm.data_ptr() % 16
    rv = torch.randn(11, 6, generator=g, device=cuda)
    for a, b in zip(ops.masked_syrk(vm, rv), ref.masked_syrk_ref(vm, rv)):
        assert torch.equal(a, b)
    pk, bk = ops.masked_syrk(torch.zeros(3, 0, 64, device=cuda),
                             torch.zeros(3, 0, device=cuda))
    assert pk.shape == (3, 64, 64) and not pk.any() and not bk.any()


def _spd_systems(g, b, k, cond, device):
    """b SPD systems Q diag(s) Q^T with s spread log-evenly over [1, cond]
    (condition number `cond`), rhs and noise, from one generator."""
    q, _ = torch.linalg.qr(torch.randn(b, k, k, generator=g, device=device))
    s = torch.logspace(0, float(np.log10(cond)), k, device=device)
    prec = (q * s) @ q.transpose(1, 2)
    prec = 0.5 * (prec + prec.transpose(1, 2))
    return (prec, torch.randn(b, k, generator=g, device=device),
            torch.randn(b, k, generator=g, device=device))


@pytest.mark.parametrize("k", RANKS)
@pytest.mark.parametrize("b", [1, 7, 37, 1000])
@pytest.mark.parametrize("cond", [10.0, 1e3])
def test_chol_kernel_takes_the_batch_as_it_is(cuda, b, k, cond):
    """Batches that fill no whole block, at condition numbers up to about
    1e3: within 2e-3 of the plain version, and the same bits on two calls."""
    g = torch.Generator(device=cuda).manual_seed(b * 100 + k)
    prec, rhs, z = _spd_systems(g, b, k, cond, cuda)
    ops.reset_launches()
    x = ops.chol_solve_sample(prec, rhs, z)
    assert ops.LAUNCHES["chol_solve_sample"] == 1 and x.shape == (b, k)
    torch.testing.assert_close(x, ref.chol_solve_sample_ref(prec, rhs, z),
                               rtol=2e-3, atol=2e-3)
    assert torch.equal(ops.chol_solve_sample(prec, rhs, z), x)


@pytest.mark.parametrize("k", RANKS)
@pytest.mark.parametrize("indefinite", ["clamp", "nan"])
def test_chol_kernel_not_positive_definite_matches_plain(cuda, k, indefinite):
    """Negative pivots, a NaN one and a positive definite system: under
    "clamp" the clamp's values, under "nan" NaN rows, where the plain
    version has them."""
    eye = torch.eye(k, device=cuda)
    nan_pivot = eye.clone()
    nan_pivot[k // 2, k // 2] = float("nan")
    bad = torch.stack([-eye, eye * torch.linspace(-1, 1, k, device=cuda), nan_pivot,
                       2 * eye])
    ones = torch.ones(4, k, device=cuda)
    xk = ops.chol_solve_sample(bad, ones, ones, indefinite=indefinite)
    xp = ref.chol_solve_sample_ref(bad, ones, ones, indefinite=indefinite)
    fin = torch.isfinite(xp)
    assert torch.equal(torch.isfinite(xk), fin)
    torch.testing.assert_close(xk[fin], xp[fin], rtol=2e-3, atol=2e-3)
    if indefinite == "nan":
        assert torch.isnan(xk[:3]).all() and fin[3].all()


@pytest.mark.parametrize("b,n,d,topk,slab", [
    (40, 3000, 256, 10, None),
    (9, 700, 64, 600, None),
    (7, 1000, 32, 1, None),          # k = 1
    (5, 777, 16, 777, None),         # k = n, the whole row
    (3, 9000, 8, 8192, None),        # k = TOPN_MAX_K
    (4097, 300, 16, 20, None),       # B one past a user tile
    (64, 5775, 256, 1024, None),     # the ChEMBL catalogue at the serving width
    (11, 1000, 6, 50, None),         # D = 6: zero columns up to the kernel's depth
    (13, 3000, 24, 300, 256),        # several slabs: a running best across them
    (6, 1000, 8, 700, 128),          # k beyond a slab
])
def test_topn_kernel_matches_plain_bitwise(cuda, b, n, d, topk, slab):
    g = torch.Generator(device=cuda).manual_seed(1)
    u = torch.randn(b, d, generator=g, device=cuda)
    v = torch.randn(n, d, generator=g, device=cuda)
    # planted ties, inside and across the 128-item tiles and the slabs
    for a in (9, n - 1, n // 2, min(130, n - 2)):
        v[a] = v[2]
    ops.reset_launches()
    vk, ik = ops.topn_scores(u, v, topk, slab=slab)
    assert ops.LAUNCHES["topn_scores"] == 1
    vp, ip = ref.topn_scores_ref(u, v, topk)
    assert torch.equal(ik, ip) and torch.equal(vk, vp)


def test_topn_kernel_dyadic_ties_across_slabs(cuda):
    """Dyadic inputs sum exactly, so whole groups of items tie; the lowest
    index must win every tie, across tiles and slabs."""
    g = torch.Generator(device=cuda).manual_seed(3)
    u = torch.randint(-4, 5, (50, 12), generator=g, device=cuda).float() / 4
    v = torch.randint(-4, 5, (2000, 12), generator=g, device=cuda).float() / 4
    for slab in (None, 128, 640):
        vk, ik = ops.topn_scores(u, v, 300, slab=slab)
        vp, ip = ref.topn_scores_ref(u, v, 300)
        assert torch.equal(ik, ip) and torch.equal(vk, vp)


def test_topn_kernel_from_two_threads_at_different_shapes(cuda):
    """The serving tier calls top-N from several threads at once, a cold
    request's call (k = 8,192: its selection takes more shared memory than
    the 48 KB a kernel gets unasked) beside a warm one's (k = 10). A launch
    that set the selection kernel's shared-memory limit to its own size let
    the small call lower it under the large call's launch, which failed."""
    import threading

    g = torch.Generator(device=cuda).manual_seed(5)
    cases = {"cold": (torch.randn(3, 16, generator=g, device=cuda),
                      torch.randn(9000, 16, generator=g, device=cuda), 8192),
             "warm": (torch.randn(8, 16, generator=g, device=cuda),
                      torch.randn(500, 16, generator=g, device=cuda), 10)}
    want = {name: ref.topn_scores_ref(*case) for name, case in cases.items()}
    errors, got = [], {}

    def serve(name):
        try:
            for _ in range(2000):
                got[name] = ops.topn_scores(*cases[name])
            torch.cuda.synchronize()
        except RuntimeError as e:
            errors.append(f"{name}: {e}")

    threads = [threading.Thread(target=serve, args=(name,)) for name in cases]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    for name, (vals, idx) in got.items():
        assert torch.equal(vals, want[name][0]) and torch.equal(idx, want[name][1])


@pytest.mark.parametrize("bh,bhk,s,d,window,cap,dtype", [
    (4, 4, 128, 32, 0, 0.0, torch.float32),        # causal
    (2, 2, 256, 64, 64, 0.0, torch.float32),       # window
    (3, 3, 128, 32, 0, 30.0, torch.float32),       # softcap
    (2, 2, 200, 32, 0, 0.0, torch.float32),        # ragged S
    (1, 1, 384, 128, 128, 50.0, torch.float32),
    (8, 4, 300, 256, 100, 50.0, torch.float32),    # D = 256, GQA, ragged
    (8, 4, 300, 256, 100, 50.0, torch.bfloat16),
    (2, 2, 128, 64, 0, 0.0, torch.bfloat16),
    (8, 4, 1000, 256, 256, 50.0, torch.bfloat16),  # peaked: q x 6
])
def test_flash_attention_kernel_matches_plain(cuda, bh, bhk, s, d, window, cap, dtype):
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q_scale = 6.0 if s == 1000 else 1.0
    q = (q_scale * torch.randn(bh, s, d, generator=g, device=cuda)).to(dtype)
    k = torch.randn(bhk, s, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(bhk, s, d, generator=g, device=cuda).to(dtype)
    kw = dict(causal=True, window=window, softcap=cap)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.LAUNCHES["flash_attention"] == 1 and got.dtype == dtype
    want = ref.flash_attention_ref(q, k, v, **kw)
    tol = 3e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7, atol=1e-5)


def test_flash_attention_kernel_non_causal_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(4, 256, 64, generator=g, device=cuda) for _ in range(3))
    torch.testing.assert_close(ops.flash_attention(q, k, v, causal=False),
                               ref.flash_attention_ref(q, k, v, causal=False),
                               rtol=3e-4, atol=3e-4)


def test_flash_attention_refuses_what_the_kernel_cannot_take(cuda):
    q = torch.zeros(2, 64, 64, device=cuda)
    with pytest.raises(ValueError):
        ops.flash_attention(q.half(), q.half(), q.half())              # fp16
    with pytest.raises(ValueError):
        ops.flash_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                            q[..., :48].contiguous())                  # D = 48
    with pytest.raises(ValueError):
        ops.flash_attention(q, q.double(), q)                          # mixed dtypes
    k32 = q[:, :32].contiguous()                                       # S_k = 32 < S_q
    with pytest.raises(ValueError):                                    # lse (BH, S_k)
        ops.flash_attention_bwd(q, k32, k32, q, torch.zeros(2, 32, device=cuda), q,
                                causal=False, window=0, softcap=0.0, scale=0.125)
    lse = torch.zeros(2, 64, device=cuda)
    with pytest.raises(ValueError):                                    # fp16 backward
        ops.flash_attention_bwd(q.half(), q.half(), q.half(), q.half(), lse, q.detach(),
                                causal=True, window=0, softcap=0.0, scale=0.125)
    with pytest.raises(ValueError):                                    # o not fp32
        ops.flash_attention_bwd(*(q.detach().bfloat16() for _ in range(4)), lse,
                                q.detach().bfloat16(), causal=True, window=0,
                                softcap=0.0, scale=0.125)


def _flash_inputs(g, bh, bhk, s, d, q_scale, dtype, device):
    q = (q_scale * torch.randn(bh, s, d, generator=g, device=device)).to(dtype)
    k = torch.randn(bhk, s, d, generator=g, device=device).to(dtype)
    v = torch.randn(bhk, s, d, generator=g, device=device).to(dtype)
    return q, k, v


def _exact_attention(q, k, v, *, causal, window, softcap):
    """The attention of the same inputs in float64, head by head (S_q
    queries over S_k keys, both from position 0)."""
    rep = q.shape[0] // k.shape[0]
    d = q.shape[2]
    diff = (torch.arange(q.shape[1], device=q.device)[:, None]
            - torch.arange(k.shape[1], device=q.device)[None, :])
    seen = diff >= 0 if causal else torch.ones_like(diff, dtype=torch.bool)
    if window:
        seen &= diff < window
    out = []
    for h in range(q.shape[0]):
        sc = q[h].double() @ k[h // rep].double().T / d ** 0.5
        if softcap:
            sc = torch.tanh(sc / softcap) * softcap
        out.append(torch.softmax(sc.masked_fill(~seen, float("-inf")), -1)
                   @ v[h // rep].double())
    return torch.stack(out)


def _flash_bf16_holds(q, k, v, against_plain_ulp=True, **kw):
    """3e-2 of the plain version, one bf16 ulp of it and of float64."""
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.LAUNCHES["flash_attention"] == 1 and got.dtype == torch.bfloat16
    want = ref.flash_attention_ref(q, k, v, **kw).float()
    torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)
    if against_plain_ulp:
        torch.testing.assert_close(got.float(), want, rtol=2.0 ** -7, atol=1e-5)
    torch.testing.assert_close(got.double(), _exact_attention(q, k, v, **kw),
                               rtol=2.0 ** -7, atol=1e-5)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("s", [1, 17, 63, 65, 1000])
def test_flash_bf16_tensor_core_kernel_shapes(cuda, d, s):
    """Every head width, at sequences ragged against the 128-row query and
    64-key tiles, GQA 2, softcap 50."""
    g = torch.Generator(device=cuda).manual_seed(d * 7 + s)
    q, k, v = _flash_inputs(g, 4, 2, s, d, 1.0, torch.bfloat16, cuda)
    _flash_bf16_holds(q, k, v, causal=True, window=0, softcap=50.0)


@pytest.mark.parametrize("d,rep,window,cap,q_scale", [
    (256, 2, 64, 50.0, 1.0),     # window at a key-tile edge
    (256, 2, 63, 50.0, 1.0),     # ... and one off it
    (256, 2, 65, 50.0, 1.0),
    (64, 1, 128, 0.0, 1.0),      # at a query-tile edge
    (64, 4, 127, 50.0, 1.0),
    (256, 1, 0, 50.0, 6.0),      # peaked scores, GQA 1
    (256, 4, 256, 50.0, 6.0),    # GQA 4
    (128, 2, 0, 0.0, 6.0),
    (256, 2, 4096, 50.0, 16.0),  # scores of std 16, past the softcap
    (32, 4, 0, 50.0, 16.0),
])
def test_flash_bf16_tensor_core_kernel_edges(cuda, d, rep, window, cap, q_scale):
    g = torch.Generator(device=cuda).manual_seed(d + rep + window)
    q, k, v = _flash_inputs(g, 4 * rep, 4, 1000, d, q_scale, torch.bfloat16, cuda)
    _flash_bf16_holds(q, k, v, causal=True, window=window, softcap=cap)


def test_flash_bf16_tensor_core_kernel_q16_softcap0(cuda):
    """Scores of std 16 and no softcap, the most peaked case. Here the
    plain version's own fp32 rounding takes it about as far from the
    float64 attention as one bf16 ulp (atol 1e-5) allows, or farther, so
    a kernel within that limit of the true value may lie outside it of
    the plain version (chip_smoke.py prints the distances at S = 8,192,
    PERF.md §6). The kernel is held to 3e-2 of the plain version and to
    one ulp of float64."""
    g = torch.Generator(device=cuda).manual_seed(258)
    q, k, v = _flash_inputs(g, 8, 4, 1000, 256, 16.0, torch.bfloat16, cuda)
    _flash_bf16_holds(q, k, v, against_plain_ulp=False, causal=True, window=0,
                      softcap=0.0)


def test_flash_bf16_tensor_core_kernel_non_causal(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = _flash_inputs(g, 4, 2, 256, 128, 1.0, torch.bfloat16, cuda)
    _flash_bf16_holds(q, k, v, causal=False, window=0, softcap=50.0)


def test_flash_dtypes_take_their_own_kernels(cuda):
    """bf16 launches the tensor-core kernel and fp32 the SIMT kernel, as
    the profiler names them; each counts as one launch, and fp32 gives
    the same bits on every call."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(4)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _flash_inputs(g, 4, 2, 300, 256, 1.0, dtype, cuda)
        kw = dict(causal=True, window=100, softcap=50.0)
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention"] == 1
        names = [e.key for e in prof.key_averages() if "flash" in e.key]
        assert len(names) == 1 and ops.FLASH_KERNEL_NAMES[dtype] in names[0], names
        if dtype == torch.float32:
            assert torch.equal(ops.flash_attention(q, k, v, **kw), out)


# ---------------------------------------------------------------------------
# the fold-in path: the kernels at the shapes fold_in gives them
# ---------------------------------------------------------------------------
def _fold_in_case(k, s=3, b=24, n=300, seed=0):
    from repro_torch.checkpoint import RetainedSample
    from repro_torch.data import SparseRatings

    rng = np.random.default_rng(seed + k)
    draws = []
    for step in range(s):
        a = rng.normal(size=(k, k)).astype(np.float32) / np.sqrt(k)
        draws.append(RetainedSample(
            step=step, u=rng.normal(size=(10, k)).astype(np.float32),
            v=rng.normal(size=(n, k)).astype(np.float32) * 0.3,
            hyper_u_mu=rng.normal(size=k).astype(np.float32) * 0.2,
            hyper_u_lam=a @ a.T + 2 * np.eye(k, dtype=np.float32),
            hyper_v_mu=np.zeros(k, np.float32), hyper_v_lam=np.eye(k, dtype=np.float32),
            global_mean=1.5, alpha=2.0))
    degrees = rng.integers(0, 40, b)
    degrees[:2] = (300, 0)         # a user split over rows, a user with none
    rows = np.repeat(np.arange(b), degrees).astype(np.int32)
    cols = np.concatenate([rng.choice(n, d, replace=False) for d in degrees]).astype(np.int32)
    vals = rng.normal(1.5, 1.0, len(cols)).astype(np.float32)
    z = rng.normal(size=(s, b, k)).astype(np.float32)
    return draws, SparseRatings(rows, cols, vals, (b, n)), z


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("engine", ["fused", "kernel"])
@pytest.mark.parametrize("k", [16, 32, 64])
def test_fold_in_kernels_match_plain_on_the_fold_in_inputs(cuda, monkeypatch, k,
                                                           engine, cached):
    """Each kernel fold_in launches, held against its plain version on the
    very inputs it was given (syrk kernels bit for bit, the solve to 2e-3),
    and the fold-in against the plain path on the CPU."""
    from repro_torch.serve import FoldInPlanCache, PosteriorEnsemble, fold_in

    draws, ratings, z = _fold_in_case(k)
    calls, depth = [], [0]

    def recording(name):
        real = getattr(ops, name)

        def rec(*a, **kw):
            # the wrappers call themselves on flattened leading axes: only
            # the outermost call is fold_in's
            depth[0] += 1
            try:
                out = real(*a, **kw)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                calls.append((name, a, kw, out))
            return out
        monkeypatch.setattr(ops, name, rec)

    for name in ("gather_syrk_seg", "masked_syrk", "chol_solve_sample"):
        recording(name)
    ens = PosteriorEnsemble(draws, device=cuda)
    cache = FoldInPlanCache() if cached else None
    ops.reset_launches()
    got = fold_in(None, ratings, ens, z=z, engine=engine, plan_cache=cache)
    torch.cuda.synchronize()
    launches = ops.launches()
    names = [c[0] for c in calls]
    if engine == "fused":
        assert set(names) == {"gather_syrk_seg"} and launches["chol_solve_sample"] == 0
    else:
        assert names.count("chol_solve_sample") == 1 and "gather_syrk_seg" not in names
    assert launches[names[0]] == names.count(names[0]) > 0
    for name, a, kw, out in calls:
        if name == "gather_syrk_seg":
            want = ref.gather_syrk_seg_ref(*a, bf16_gather=kw["bf16_gather"],
                                           identity_segments=kw["identity_segments"])
        elif name == "masked_syrk":
            want = ref.masked_syrk_ref(a[0].reshape((-1,) + a[0].shape[-2:]),
                                       a[1].reshape((-1, a[1].shape[-1])))
            out = tuple(o.reshape(w.shape) for o, w in zip(out, want))
        else:
            prec, rhs, zz = a
            assert prec.shape[:2] == (3, 32 if cached else 24)   # one launch, S x B
            want = ref.chol_solve_sample_ref(prec.reshape(-1, k, k),
                                             rhs.reshape(-1, k), zz.reshape(-1, k))
            torch.testing.assert_close(out.reshape(want.shape), want, rtol=2e-3,
                                       atol=2e-3)
            continue
        assert all(torch.equal(o, w) for o, w in zip(out, want)), name
    plain = fold_in(None, ratings, PosteriorEnsemble(draws, device="cpu"), z=z,
                    engine="einsum")
    torch.testing.assert_close(got.cpu(), plain, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# the distributed sampler: gather_syrk_seg at the grid plans' shapes
# ---------------------------------------------------------------------------
def _dist(devices, mode, engine, k):
    from repro_torch.core.distributed import DistributedBPMF
    from repro_torch.data import synthetic_lowrank, train_test_split

    ratings, _, _ = synthetic_lowrank(300, 200, k_true=8, nnz=9000, noise=0.3, seed=3)
    train, test = train_test_split(ratings, 0.1, seed=4)
    return DistributedBPMF(train, test, devices=devices, k=k, alpha=11.0, width="auto",
                           mode=mode, engine=engine)


@pytest.mark.parametrize("mode", ["ring", "allgather", "async"])
@pytest.mark.parametrize("k", [16, 64])
def test_grid_plan_gather_syrk_seg_launches_match_plain(cuda, monkeypatch, k, mode):
    """Every launch of one fused sweep of 4 shards on one card, held bit for
    bit against the plain version on its own inputs (taken as the launch
    made them: a receive buffer is written again two steps on); the sweep
    against the same sweep on the CPU."""
    from repro_torch.core.distributed import shard_devices

    calls = []
    real = ops.gather_syrk_seg

    def rec(*a, **kw):
        out = real(*a, **kw)
        calls.append((a[:5] + (a[5].clone(),), out))
        return out

    monkeypatch.setattr(ops, "gather_syrk_seg", rec)
    d = _dist(shard_devices(4), mode, "fused", k)
    s0 = d.init(0)
    noise = d.draw_noise()
    ops.reset_launches()
    st = d.sweep(s0, noise)
    torch.cuda.synchronize()
    assert ops.launches()["gather_syrk_seg"] == len(calls) == (8 if mode == "allgather" else 32)
    for a, out in calls:
        assert a[0].shape[1] in (d.u_plan.width, d.v_plan.width)
        want = ref.gather_syrk_seg_ref(*a)
        assert all(torch.equal(o, w) for o, w in zip(out, want))
    plain = _dist([torch.device("cpu")] * 4, mode, "fused", k)
    cpu = plain.sweep(_on_cpu(s0), _on_cpu(noise))
    for got, want in zip(d.gather_factors(st), plain.gather_factors(cpu)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def _on_cpu(x):
    """A copy on the CPU of a state or noise tuple, field by field."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple):
        fields = [_on_cpu(f) for f in x]
        return type(x)(*fields) if hasattr(x, "_fields") else tuple(fields)
    return x


def test_async_first_sweep_v_bit_equal_to_ring_on_the_card(cuda):
    from repro_torch.core.distributed import shard_devices

    ring = _dist(shard_devices(4), "ring", "fused", 64)
    asyn = _dist(shard_devices(4), "async", "fused", 64)
    s0 = ring.init(0)
    noise = ring.draw_noise()
    _, v_ring = ring.gather_factors(ring.sweep(s0, noise))
    _, v_async = asyn.gather_factors(asyn.sweep(s0, noise), coupled=False)
    assert np.array_equal(v_ring, v_async)


@pytest.mark.parametrize("mode", ["async", "ring"])
def test_sweeps_over_four_cards_bit_equal_to_one_card(cuda, mode):
    """One shard a card against the four shards on cuda:0, three sweeps
    from the same state on the same noise: bit for bit the same factors and
    hyperparameters, the ring's copies between cards moving what the copies
    on one card move. Under the profiler each card's accumulates, solves,
    waits and forwards are spans on that card. Skips with fewer than four
    cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans
    from repro_torch.core.distributed import DistState, shard_devices

    four = _dist(shard_devices(4), mode, "fused", 64)
    one = _dist([torch.device("cuda", 0)] * 4, mode, "fused", 64)
    assert [d.index for d in four.devices] == [0, 1, 2, 3]
    s1 = one.init(0)
    s4 = DistState(u=tuple(x.to(d) for x, d in zip(s1.u, four.devices)),
                   v=tuple(x.to(d) for x, d in zip(s1.v, four.devices)),
                   hyper_u=s1.hyper_u, hyper_v=s1.hyper_v, step=0,
                   v_eval=None if s1.v_eval is None else
                   tuple(x.to(d) for x, d in zip(s1.v_eval, four.devices)))
    spans.reset()
    for i in range(3):
        noise = one.draw_noise()
        s1 = one.sweep(s1, noise)
        if i < 2:
            s4 = four.sweep(s4, noise)
            continue
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            s4 = four.sweep(s4, noise)
    for a, b in zip(one.gather_factors(s1, coupled=False),
                    four.gather_factors(s4, coupled=False)):
        assert np.array_equal(a, b)
    for a, b in zip(s1.hyper_u + s1.hyper_v, s4.hyper_u + s4.hyper_v):
        assert torch.equal(a, b)
    by = spans.totals_by_card()
    spans.reset()
    for name in ("dist.accumulate", "dist.solve", "dist.wait", "dist.exchange"):
        assert set(by[name]) == {0, 1, 2, 3}, name
        assert all(t["device_s"] >= 0 for t in by[name].values())
    assert set(by["dist.sweep"]) == set(by["dist.stats"]) == {0}


# ---------------------------------------------------------------------------
# each launch on its tensor's card
# ---------------------------------------------------------------------------
def test_kernels_launch_on_their_tensors_card_while_another_is_current(cuda):
    """Tensors on cuda:1 while cuda:0 is current: every wrapper launches on
    cuda:1 (its persistent grid sized and its shared memory set for that
    card), the flash backward through the forward's autograd Function, and
    holds against its plain version there. Skips with fewer than two
    cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    g = torch.Generator(device=dev).manual_seed(5)
    with torch.cuda.device(0):
        ops.reset_launches()
        idx, val, msk, seg = _bucket(np.random.default_rng(5), 300, 3, 200, 40, dev)
        ptr = torch.tensor(ops.segment_offsets(seg.cpu().numpy(), 40), device=dev)
        v = torch.randn(200, 64, generator=g, device=dev)
        got = ops.gather_syrk_seg(idx, val, msk, seg, 40, v, seg_ptr=ptr)
        want = ref.gather_syrk_seg_ref(idx, val, msk, seg, 40, v)
        assert all(a.device == dev and torch.equal(a, b) for a, b in zip(got, want))
        vm = torch.randn(50, 5, 64, generator=g, device=dev)
        rv = torch.randn(50, 5, generator=g, device=dev)
        assert all(torch.equal(a, b) for a, b in zip(ops.masked_syrk(vm, rv),
                                                     ref.masked_syrk_ref(vm, rv)))
        a = torch.randn(37, 64, 64, generator=g, device=dev)
        prec = a @ a.transpose(1, 2) + 7.0 * torch.eye(64, device=dev)
        rhs, z = (torch.randn(37, 64, generator=g, device=dev) for _ in range(2))
        torch.testing.assert_close(ops.chol_solve_sample(prec, rhs, z),
                                   ref.chol_solve_sample_ref(prec, rhs, z),
                                   rtol=2e-3, atol=2e-3)
        u, items = torch.randn(9, 64, generator=g, device=dev), v
        for a, b in zip(ops.topn_scores(u, items, 10), ref.topn_scores_ref(u, items, 10)):
            assert torch.equal(a, b)
        q, k, vv = (torch.randn(4, 300, 64, generator=g, device=dev).to(torch.bfloat16)
                    for _ in range(3))
        do = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
        out, *grads = _flash_grads(q, k, vv, do, softcap=50.0)
        torch.testing.assert_close(out.float(),
                                   ref.flash_attention_ref(q, k, vv, softcap=50.0).float(),
                                   rtol=3e-2, atol=3e-2)
        assert all(t.device == dev for t in grads)
        _grads_hold(grads, _exact_grads(q, k, vv, do, softcap=50.0), torch.bfloat16)
        assert torch.cuda.current_device() == 0
        assert all(n == 1 for n in ops.launches().values())


# ---------------------------------------------------------------------------
# the order-fixed segment sum and what rides it
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_seg,max_len,tail,stacked", [
    (50, 3000, (64, 64), False), (20000, 40, (64, 64), False), (200000, 6, (64,), False),
    (300, 40, (16, 16), False), (300, 40, (16, 16), True), (300, 40, (64, 64), True)])
def test_segment_reduce_rows_in_row_order_on_the_card(cuda, n_seg, max_len, tail, stacked):
    """Bit for bit the plain version's row-order sums, the same bits on two
    calls and, at the smaller shapes, on the CPU (some segments are
    empty)."""
    from repro_torch.core.gibbs import segment_reduce_rows

    rng = np.random.default_rng(n_seg)
    lengths = rng.integers(0, max_len + 1, n_seg)
    seg = np.repeat(np.arange(n_seg), lengths).astype(np.int32)
    lead = (2,) if stacked else ()
    shape = lead + (len(seg),) + tail
    g = torch.Generator(device=cuda).manual_seed(n_seg)
    rows = (torch.randn(shape, generator=g, device=cuda)
            * torch.exp(3 * torch.randn(shape, generator=g, device=cuda)))
    off = torch.tensor(ops.segment_offsets(seg, n_seg), device=cuda)
    a = segment_reduce_rows(rows, off, stacked=stacked)
    b = segment_reduce_rows(rows, off, stacked=stacked)
    want = ref.segment_sums_in_order(rows, torch.tensor(seg, device=cuda), n_seg,
                                     stacked=stacked)
    assert torch.equal(a, want) and torch.equal(a, b)
    if rows.numel() <= 1 << 24:
        assert torch.equal(a.cpu(), segment_reduce_rows(rows.cpu(), off.cpu(),
                                                        stacked=stacked))


def test_sum_rows_by_id_on_the_card_is_the_cpus(cuda):
    from repro_torch.core.gibbs import segment_reduce_rows, sum_rows_by_id

    rng = np.random.default_rng(3)
    ids = torch.tensor(rng.integers(0, 5000, 40000))
    rows = torch.tensor(rng.normal(size=(40000, 64)).astype(np.float32))
    got = sum_rows_by_id(rows.to(cuda), ids.to(cuda), 5000)
    assert torch.equal(got.cpu(), sum_rows_by_id(rows, ids, 5000))
    assert torch.equal(got, sum_rows_by_id(rows.to(cuda), ids.to(cuda), 5000))
    with pytest.raises(ValueError, match="two or more axes"):
        segment_reduce_rows(rows[:, 0].to(cuda), torch.tensor([0, 40000], device=cuda))


def test_async_first_sweep_v_bit_equal_to_ring_through_einsum_on_the_card(cuda):
    from repro_torch.core.distributed import shard_devices

    ring = _dist(shard_devices(4), "ring", "einsum", 64)
    asyn = _dist(shard_devices(4), "async", "einsum", 64)
    s0 = ring.init(0)
    noise = ring.draw_noise()
    _, v_ring = ring.gather_factors(ring.sweep(s0, noise))
    _, v_async = asyn.gather_factors(asyn.sweep(s0, noise), coupled=False)
    assert np.array_equal(v_ring, v_async)


@pytest.mark.parametrize("engine", ["kernel", "einsum", "fused"])
def test_sweep_equal_to_itself_from_run_to_run(cuda, engine):
    from repro_torch.core import GibbsSampler
    from repro_torch.data import movielens_like, train_test_split

    ratings, _, _ = movielens_like(scale=0.02, seed=0)
    train, test = train_test_split(ratings, 0.1, seed=1)
    s = GibbsSampler(train, test, k=64, alpha=4.0, burn_in=0, engine=engine)
    s0 = s.init(0)
    noise = s.draw_noise()
    a, b = s.sweep(s0, noise), s.sweep(s0, noise)
    assert torch.equal(a.u, b.u) and torch.equal(a.v, b.v)
    assert torch.equal(a.pred_sum, b.pred_sum)


def _add_into_prior(counterpart, buckets, n_items, hyper, alpha):
    """The fused engine's systems as they were built before the kernel
    stored them: V padded to the kernel's rank, the prior copied into
    every slot, then alpha times each bucket's statistics (the plain
    store's kernel) added into its items' slots."""
    from repro_torch.core import gibbs

    k = counterpart.shape[-1]
    prec_all = hyper.lam.expand(n_items, k, k).clone()
    rhs_all = (hyper.lam @ hyper.mu).expand(n_items, k).clone()
    padded = ops.pad_rank(counterpart, ops.kernel_rank(k))
    for b in buckets:
        prec, rhs = gibbs.bucket_stats(padded, b, engine="fused")
        prec_all[b.seg_item_ids] += alpha * prec[..., :k, :k]
        rhs_all[b.seg_item_ids] += alpha * rhs[..., :k]
    return prec_all, rhs_all


def _ragged_sampler(k, **kw):
    """A fused sampler over ml-20m-shaped ratings with 5 users and 7 items
    that have none, on a ladder whose widest bucket splits items over
    rows."""
    from repro_torch.core import GibbsSampler
    from repro_torch.data import SparseRatings, movielens_like, train_test_split

    ratings, _, _ = movielens_like(scale=0.02, seed=0)
    train, test = train_test_split(ratings, 0.1, seed=1)
    m, n = train.shape
    train = SparseRatings(train.rows, train.cols, train.vals, (m + 5, n + 7))
    test = SparseRatings(test.rows, test.cols, test.vals, (m + 5, n + 7))
    return GibbsSampler(train, test, k=k, alpha=4.0, burn_in=0, widths=(4, 16, 64),
                        engine="fused", **kw)


@pytest.mark.parametrize("k", [10, 64])
def test_fused_systems_and_sweep_are_the_add_flow_bit_for_bit(cuda, monkeypatch, k):
    """posterior_systems(engine="fused") on the card gives both sides'
    systems of the flow it replaced bit for bit (items no bucket covers,
    multi-row segments, a rank the kernel pads), and a sweep through
    either gives the same U and V."""
    from repro_torch.core import gibbs

    s = _ragged_sampler(k)
    assert s.systems_written["users"]["prior"] >= 5 and s.systems_written["items"]["prior"] >= 7
    assert any(not b.identity_segments for b in s.item_buckets + s.user_buckets)
    st = s.init(0)
    noise = s.draw_noise()
    for cp, buckets, n, hyper, unc in ((st.u, s.item_buckets, s.n, st.hyper_v, s.item_uncovered),
                                       (st.v, s.user_buckets, s.m, st.hyper_u, s.user_uncovered)):
        got = gibbs.posterior_systems(cp, buckets, n, hyper, s.alpha, engine="fused",
                                      uncovered=unc)
        want = _add_into_prior(cp, buckets, n, hyper, s.alpha)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    a = s.sweep(st, noise)
    monkeypatch.setattr(gibbs, "posterior_systems",
                        lambda cp, b, n, h, alpha, **kw: _add_into_prior(cp, b, n, h, alpha))
    b = s.sweep(st, noise)
    assert torch.equal(a.u, b.u) and torch.equal(a.v, b.v)


def test_fused_sweep_assembles_with_one_launch_a_bucket(cuda):
    """A fused sweep launches gather_syrk_seg once a bucket, and inside the
    two `gibbs.assemble` spans the profiler sees the "into" op and no
    aten::index or aten::index_put_: no pass gathers or scatters the
    systems."""
    from torch.profiler import ProfilerActivity, profile

    s = _ragged_sampler(64)
    st = s.init(0)
    noise = s.draw_noise()
    s.sweep(st, noise)                       # builds and warms the kernels
    torch.cuda.synchronize()
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s.sweep(st, noise)
        torch.cuda.synchronize()
    assert ops.launches()["gather_syrk_seg"] == len(s.item_buckets) + len(s.user_buckets)
    # host events: a span is also drawn on the card's timeline
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    spans = [e for e in events if e.name == "gibbs.assemble"]
    assert len(spans) == 2
    inside = {e.name for e in events for a in spans
              if e.thread == a.thread and e is not a
              and a.time_range.start <= e.time_range.start
              and e.time_range.end <= a.time_range.end}
    assert "repro_torch::gather_syrk_seg_into" in inside, sorted(inside)
    assert not inside & {"aten::index", "aten::index_put_"}, sorted(inside)


def test_fused_sweep_solves_with_the_kernel(cuda, monkeypatch):
    """A fused sweep launches chol_solve_sample once a half-sweep and calls
    the library's Cholesky only inside the two hyperparameter draws; its
    factors are within the solve's tolerance of the plain versions' sweep
    on the CPU from the same state and noise."""
    from repro_torch.core import GibbsSampler
    from repro_torch.core import gibbs
    from repro_torch.data import movielens_like, train_test_split

    depth, draws, calls = [0], [0], []
    real_draw, real_chol = gibbs.sample_normal_wishart, torch.linalg.cholesky_ex

    def draw(*a, **kw):
        depth[0] += 1
        draws[0] += 1
        try:
            return real_draw(*a, **kw)
        finally:
            depth[0] -= 1

    def chol(*a, **kw):
        calls.append(depth[0] > 0)
        return real_chol(*a, **kw)

    monkeypatch.setattr(gibbs, "sample_normal_wishart", draw)
    monkeypatch.setattr(torch.linalg, "cholesky_ex", chol)
    ratings, _, _ = movielens_like(scale=0.005, seed=0)
    train, test = train_test_split(ratings, 0.1, seed=1)
    s = GibbsSampler(train, test, k=64, alpha=4.0, burn_in=0, engine="fused")
    s0 = s.init(0)
    noise = s.draw_noise()
    ops.reset_launches()
    got = s.sweep(s0, noise)
    torch.cuda.synchronize()
    assert ops.launches()["chol_solve_sample"] == 2
    assert draws[0] == 2 and calls and all(calls)
    plain = GibbsSampler(train, test, k=64, alpha=4.0, burn_in=0, engine="fused",
                         device="cpu")
    want = plain.sweep(_on_cpu(s0), _on_cpu(noise))
    for name in ("u", "v"):
        torch.testing.assert_close(getattr(got, name).cpu(), getattr(want, name),
                                   rtol=2e-3, atol=2e-3, msg=name)


def test_sgld_chains_deterministic_on_the_card(cuda):
    """Two chains of 10 steps from one seed, equal bit for bit: the
    duplicate rows of a minibatch are added without atomics."""
    from repro_torch.core import DistributedSGLD, SGLDSampler
    from repro_torch.core.distributed import shard_devices
    from repro_torch.data import movielens_like, train_test_split

    ratings, _, _ = movielens_like(scale=0.02, seed=0)
    train, test = train_test_split(ratings, 0.1, seed=1)
    runs = []
    for _ in range(2):
        s = SGLDSampler(train, test, k=64, alpha=4.0, burn_in=5, minibatch=4096,
                        hyper_every=3)
        runs.append(s.run(10, seed=3))
    assert torch.equal(runs[0].u, runs[1].u) and torch.equal(runs[0].v, runs[1].v)
    assert torch.equal(runs[0].pred_sum, runs[1].pred_sum)
    for mode in ("ring", "allgather", "async"):
        states = [DistributedSGLD(train, test, devices=shard_devices(4), k=64, alpha=4.0,
                                  width="auto", mode=mode, minibatch=4096).run(5, seed=3)
                  for _ in range(2)]
        for name in ("u", "v"):
            assert all(torch.equal(a, b) for a, b in zip(getattr(states[0], name),
                                                         getattr(states[1], name))), mode


# ---------------------------------------------------------------------------
# the flash backward and the training path
# ---------------------------------------------------------------------------
def _flash_grads(q, k, v, do, **kw):
    """(out, dq, dk, dv) through ops.flash_attention with grad."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(q, k, v, **kw)
    return (out,) + torch.autograd.grad(out, (q, k, v), do)


def _exact_grads(q, k, v, do, **kw):
    """The gradients in float64 from the plain versions, the forward's lse
    and output computed in float64 too."""
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    _, lse, o = ref.flash_attention_fwd_ref(qd, kd, vd, **kw)
    return ref.flash_attention_bwd_ref(qd, kd, vd, dod, lse, o, **kw)


def _grads_hold(got, want, dtype):
    """Each gradient within one bf16 ulp of its largest magnitude (bf16) or
    3e-4 of it (fp32, whose sums run in another order), with an atol of at
    least 1e-5, the one the forward's bf16 checks take: a gradient that is
    0 exactly (one token: dP = D) comes out of two fp32 sums in different
    orders at about 1e-7."""
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype, name
        top = float(w.abs().max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
        atol = max(ulp if dtype == torch.bfloat16 else 3e-4 * top, 1e-5)
        err = float((g.double() - w).abs().max())
        assert err <= atol, f"{name}: max abs err {err:.3e} > {atol:.3e} (max |g| {top:.3e})"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 112, 128, 256])
def test_flash_bwd_kernel_matches_plain(cuda, d, dtype):
    """Every head width in both dtypes, GQA 2, window 48, softcap 50, a
    ragged S: the kernel's gradients against the float64 plain version."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = _flash_inputs(g, 4, 2, 100, d, 1.0, dtype, cuda)
    do = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    kw = dict(causal=True, window=48, softcap=50.0)
    ops.reset_launches()
    out, *got = _flash_grads(q, k, v, do, **kw)
    torch.cuda.synchronize()
    assert ops.launches()["flash_attention"] == 1
    assert ops.launches()["flash_attention_bwd"] == 1
    _grads_hold(got, _exact_grads(q, k, v, do, **kw), dtype)
    assert torch.equal(out, ops.flash_attention(q, k, v, **kw))   # the same forward bits


@pytest.mark.parametrize("bh,bhk,s,d,window,cap,q_scale,causal", [
    (8, 4, 1000, 256, 0, 50.0, 1.0, True),      # gemma2's heads, global
    (8, 4, 1000, 256, 256, 50.0, 6.0, True),    # peaked scores, local
    (8, 8, 257, 128, 32, 0.0, 1.0, True),       # window at a tile edge
    (8, 2, 300, 64, 31, 30.0, 16.0, True),      # GQA 4, scores past the cap
    (4, 2, 256, 128, 0, 50.0, 1.0, False),      # non-causal
    (2, 2, 1, 64, 0, 50.0, 1.0, True),          # one token
])
def test_flash_bwd_kernel_edges(cuda, bh, bhk, s, d, window, cap, q_scale, causal):
    g = torch.Generator(device=cuda).manual_seed(s + d + window)
    q, k, v = _flash_inputs(g, bh, bhk, s, d, q_scale, torch.bfloat16, cuda)
    do = torch.randn(q.shape, generator=g, device=cuda).to(torch.bfloat16)
    kw = dict(causal=causal, window=window, softcap=cap)
    _, *got = _flash_grads(q, k, v, do, **kw)
    _grads_hold(got, _exact_grads(q, k, v, do, **kw), torch.bfloat16)


def test_flash_bwd_kernel_is_the_same_from_run_to_run(cuda):
    """No atomics: two backward launches give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = _flash_inputs(g, 8, 4, 700, 256, 1.0, torch.bfloat16, cuda)
    do = torch.randn(q.shape, generator=g, device=cuda).to(torch.bfloat16)
    kw = dict(causal=True, window=128, softcap=50.0)
    a, b = _flash_grads(q, k, v, do, **kw), _flash_grads(q, k, v, do, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# The bf16 backward's tiles (csrc/flash_attention_bwd.cu, namespace mma):
# dq takes 128 query rows a block against 32-key tiles, dkdv 64 keys a block
# (16 a warp pair) against 32-row query tiles.
@pytest.mark.parametrize("bh,bhk,s,d,window,cap,q_scale", [
    (4, 4, 127, 64, 0, 50.0, 1.0),     # GQA 1; S one below a dq block
    (4, 2, 129, 128, 0, 50.0, 1.0),    # GQA 2; one above it
    (8, 2, 63, 32, 0, 50.0, 1.0),      # GQA 4; one below a dkdv block
    (4, 2, 65, 256, 0, 50.0, 6.0),     # one above it, peaked scores
    (4, 1, 31, 64, 0, 0.0, 1.0),       # one below a 32-wide tile, no softcap
    (4, 2, 33, 256, 0, 50.0, 1.0),     # one above it
    (4, 2, 257, 32, 31, 50.0, 1.0),    # a window ending one key inside a 32-key tile
    (4, 4, 257, 128, 33, 50.0, 6.0),   # one key outside it
    (8, 2, 300, 256, 63, 30.0, 1.0),   # one key inside a 64-key block
    (4, 2, 300, 64, 65, 50.0, 16.0),   # one key outside it, scores past the cap
    (4, 4, 129, 112, 0, 0.0, 1.0),     # D = 112 (7 k-steps): one above a dq block
    (8, 2, 65, 112, 31, 50.0, 6.0),    # one above a dkdv block, a window, peaked
])
def test_flash_bwd_mma_tile_edges(cuda, bh, bhk, s, d, window, cap, q_scale):
    """The tensor-core backward at the edges of its tiles, every head width
    and GQA 1, 2 and 4, held to the float64 plain version (`_grads_hold`)."""
    g = torch.Generator(device=cuda).manual_seed(bh + s + d + window)
    q, k, v = _flash_inputs(g, bh, bhk, s, d, q_scale, torch.bfloat16, cuda)
    do = torch.randn(q.shape, generator=g, device=cuda).to(torch.bfloat16)
    kw = dict(causal=True, window=window, softcap=cap)
    ops.reset_launches()
    _, *got = _flash_grads(q, k, v, do, **kw)
    torch.cuda.synchronize()
    assert ops.launches()["flash_attention_bwd"] == 1
    _grads_hold(got, _exact_grads(q, k, v, do, **kw), torch.bfloat16)


@pytest.mark.parametrize("bh,bhk,s,d,window,cap,seed,want", [
    (4, 2, 300, 128, 100, 50.0, 1, "d0fd42d6f1ceae76"),
    (8, 4, 1000, 256, 0, 50.0, 2, "ce5b4baf71ffbbdc"),
    (2, 2, 77, 32, 0, 0.0, 3, "a65aec47d66c426a"),
    (4, 1, 200, 64, 31, 30.0, 4, "45b8d917bd70da9b"),
])
def test_flash_bwd_fp32_keeps_its_bits(cuda, bh, bhk, s, d, window, cap, seed, want):
    """The fp32 backward (the SIMT kernels) and the fp32 forward give the
    bits they gave before the bf16 backward moved to the tensor cores: the
    first 16 hex digits of the sha256 of o, dq, dk and dv (fp32 bytes, in
    that order), from numpy-seeded inputs (q, k, v, dO drawn in that
    order), recorded from the SIMT-only build on an NVIDIA H100 80GB HBM3."""
    import hashlib

    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.tensor(rng.standard_normal((n, s, d)).astype(np.float32),
                                device=cuda) for n in (bh, bhk, bhk, bh))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True, window=window, softcap=cap)
    h = hashlib.sha256()
    for t in (out,) + torch.autograd.grad(out, leaves, do):
        h.update(t.detach().cpu().numpy().tobytes())
    assert h.hexdigest()[:16] == want


def test_flash_forward_writes_lse_and_the_fp32_output(cuda):
    """With grad the forward kernel also writes each row's log-sum-exp and
    the fp32 output it rounds; its bf16 output keeps its bits."""
    g = torch.Generator(device=cuda).manual_seed(12)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _flash_inputs(g, 4, 2, 333, 128, 1.0, dtype, cuda)
        kw = dict(causal=True, window=100, softcap=50.0)
        out, lse, o32 = ops._flash_forward(q, k, v, True, 100, 50.0, 128 ** -0.5, keep=True)
        assert torch.equal(out, ops.flash_attention(q, k, v, **kw))
        _, lse64, o64 = ref.flash_attention_fwd_ref(q.double(), k.double(), v.double(), **kw)
        torch.testing.assert_close(lse.double(), lse64, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(o32.double(), o64, rtol=3e-4, atol=3e-4)
        assert torch.equal(o32.to(dtype), out)


def test_matmul_f32_differentiates_on_the_card(cuda):
    """matmul_f32 on bf16 CUDA operands under grad: no raise, and the
    gradients of the CPU's a.float() @ b.float(), cast to bf16."""
    from repro_torch.models.layers import matmul_f32

    g = torch.Generator().manual_seed(0)
    for shape_a, shape_b in (((2, 3, 40, 64), (64, 50)), ((2, 3, 40, 64), (2, 3, 64, 50))):
        a = torch.randn(shape_a, generator=g).bfloat16()
        b = torch.randn(shape_b, generator=g).bfloat16()
        w = torch.randn(shape_a[:-1] + (50,), generator=g)
        grads = []
        for dev in ("cpu", cuda):
            ad, bd = (t.to(dev).requires_grad_() for t in (a, b))
            out = matmul_f32(ad, bd)
            assert out.dtype == torch.float32
            grads.append([t.cpu() for t in torch.autograd.grad((out * w.to(dev)).sum(),
                                                               (ad, bd))])
        for x, y in zip(*grads):
            assert x.dtype == y.dtype == torch.bfloat16
            torch.testing.assert_close(y.float(), x.float(), rtol=2.0 ** -7, atol=1e-3)


def test_bf16_clipping_on_the_card_rounds_once_in_fp32(cuda):
    """Clipping bf16 gradients on the card: each entry is the fp32 product
    of the gradient and the fp32 scale, rounded to bf16 once, bit for bit
    the CPU's from the same scale (a bf16 `g.mul_(scale)` on the card
    rounds the scale to bf16 first); adamw_update clips as it reads, so
    its moments are those of the clipped gradients (fp32, rtol 1e-6)."""
    from repro_torch.optim import adamw

    g = torch.Generator().manual_seed(0)
    grads = {f"layers.0.w{i}": (3.0 * torch.randn(64, 300, generator=g)).bfloat16()
             for i in range(3)}
    card = {n: t.to(cuda) for n, t in grads.items()}
    clipped, gnorm = adamw.clip_by_global_norm({n: t.clone() for n, t in card.items()},
                                               1.0)
    scale = min(1.0, 1.0 / max(float(gnorm), 1e-9))
    assert scale < 1.0
    for n, t in clipped.items():
        assert torch.equal(t.cpu(), (grads[n].float() * scale).bfloat16()), n

    cfg = adamw.AdamWConfig(lr=0.01)
    params = {n: torch.randn(t.shape, generator=g).bfloat16().to(cuda)
              for n, t in grads.items()}
    state = adamw.adamw_init(params, cfg)
    _, state, metrics = adamw.adamw_update(card, state, params, cfg)
    assert float(metrics["grad_norm"]) == float(gnorm)
    for n, t in card.items():
        assert torch.equal(t.cpu(), grads[n]), n                     # left as it was
        want = (1 - cfg.b1) * (grads[n].float() * scale).bfloat16().float()
        torch.testing.assert_close(state.m[n].cpu(), want, rtol=1e-6, atol=0)


def test_reduced_train_step_on_the_card_matches_the_cpu(cuda):
    """One make_train_step on the card (the flash forward and backward
    kernels in every layer) against the same step on the CPU, in fp32 from
    the same parameters: loss and grad_norm at rtol 1e-4, each parameter
    within 2 lr (an AdamW step moves an entry by about lr), and all but a
    few entries within 1e-6."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig

    cfg = dataclasses.replace(reduced(get_config("gemma2-2b")), dtype=torch.float32,
                              param_dtype=torch.float32, remat=True)
    opt = AdamWConfig(lr=1e-3)
    batch = TokenStream(cfg, 2, 64, seed=0)(0)
    out = {}
    for dev in ("cpu", "cuda"):
        state = init_train_state(cfg, 0, opt, device="cpu")
        if dev == "cuda":
            state.params.to(cuda)
            state = state._replace(opt=state.opt._replace(
                m={n: t.to(cuda) for n, t in state.opt.m.items()},
                v={n: t.to(cuda) for n, t in state.opt.v.items()}))
        step = make_train_step(cfg, opt, total_steps=5, device=dev)
        ops.reset_launches()
        state, metrics = step(state, batch)
        counts = ops.launches()
        out[dev] = (state, metrics, counts)
    assert out["cuda"][2]["flash_attention"] == 2 * cfg.n_layers      # forward, recompute
    assert out["cuda"][2]["flash_attention_bwd"] == cfg.n_layers
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(out["cuda"][1][key]), float(out["cpu"][1][key]),
                                   rtol=1e-4)
    lr = float(out["cpu"][1]["lr"])
    cpu = dict(out["cpu"][0].params.named_parameters())
    for name, p in out["cuda"][0].params.named_parameters():
        diff = (p.detach().cpu() - cpu[name].detach()).abs()
        assert float(diff.max()) <= 2 * lr, name
        assert int((diff > 1e-6).sum()) <= max(2, diff.numel() // 1000), name


# ---------------------------------------------------------------------------
# the other dense configs' and the MoE's attention shapes, and the MoE
# ---------------------------------------------------------------------------
# (BH, BHk, D) of one sequence of smollm-360m (15 heads over 5 KV heads, a
# group of 3), stablelm-1.6b (32 over 32), granite-moe-3b-a800m (24 over 8)
# and granite-20b (48 over 1, MQA): softcap 0 and no window on every layer
NEW_FLASH_SHAPES = [(15, 5, 64), (32, 32, 64), (24, 8, 64), (48, 1, 128)]


@pytest.mark.parametrize("bh,bhk,d", NEW_FLASH_SHAPES)
def test_flash_pair_at_the_new_configs_shapes(cuda, bh, bhk, d):
    """The forward within 3e-2 and one bf16 ulp of its plain version and of
    float64, and the backward's gradients within one bf16 ulp of their
    largest magnitude of float64, at a ragged S, softcap 0, window 0."""
    g = torch.Generator(device=cuda).manual_seed(bh * 131 + d)
    q, k, v = _flash_inputs(g, bh, bhk, 300, d, 1.0, torch.bfloat16, cuda)
    kw = dict(causal=True, window=0, softcap=0.0)
    _flash_bf16_holds(q, k, v, **kw)
    do = torch.randn(q.shape, generator=g, device=cuda).to(torch.bfloat16)
    ops.reset_launches()
    _, *got = _flash_grads(q, k, v, do, **kw)
    torch.cuda.synchronize()
    assert ops.launches()["flash_attention_bwd"] == 1
    _grads_hold(got, _exact_grads(q, k, v, do, **kw), torch.bfloat16)


def test_moe_block_on_the_card_matches_the_cpu(cuda):
    """moe_block of reduced granite-moe-3b-a800m at capacity factor 1
    (replicas dropped) on the card against the CPU, fp32: the routing's
    integers equal, out and aux at rtol 1e-5 and an atol of 1e-5 of the
    largest magnitude (the same fp32 arithmetic, summed in other orders),
    and the gradients likewise."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import layers

    cfg = dataclasses.replace(reduced(get_config("granite-moe-3b-a800m")),
                              dtype=torch.float32, param_dtype=torch.float32,
                              capacity_factor=1.0)
    moe = layers.init_moe(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(1))
    c = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    got = {}
    for dev in ("cpu", cuda):
        m = layers.init_moe(cfg, generator=None, device=dev)
        m.load_state_dict(moe.state_dict())
        xd = x.to(dev).detach().clone().requires_grad_()
        route = layers.moe_route(m, xd.detach().reshape(-1, cfg.d_model), cfg)
        out, aux = layers.moe_block(m, xd, cfg)
        ((out * c.to(dev)).sum() + aux).backward()
        got[str(dev)] = (route, out.detach().cpu(), float(aux), xd.grad.cpu(),
                         [p.grad.cpu() for p in m.parameters()])
    (rc, oc, ac, gc, pc), (rg, og, ag, gg, pg) = got.values()
    assert int((rc.counts - rc.cap).clamp(min=0).sum()) > 0
    for name in ("top_e", "counts", "rep_slot", "rep_keep", "slot_rep", "slot_used"):
        assert torch.equal(getattr(rc, name), getattr(rg, name).cpu()), name
    assert rc.cap == rg.cap
    np.testing.assert_allclose(ag, ac, rtol=1e-5)
    for a, b in [(og, oc), (gg, gc)] + list(zip(pg, pc)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


def test_moe_train_step_is_the_same_from_run_to_run(cuda):
    """Two make_train_step steps of reduced granite-moe-3b-a800m (bf16,
    remat on, S = 64: the flash kernels in every layer) from one seed's
    state on one batch give the same loss, grad_norm, parameters and
    moments bit for bit: no step of the MoE's forward or backward adds
    atomically."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig

    cfg = dataclasses.replace(reduced(get_config("granite-moe-3b-a800m")), remat=True)
    opt = AdamWConfig(lr=1e-3)
    batch = TokenStream(cfg, 2, 64, seed=0)(0)
    runs = []
    for _ in range(2):
        state = init_train_state(cfg, 0, opt)
        step = make_train_step(cfg, opt, total_steps=5)
        ops.reset_launches()
        state, metrics = step(state, batch)
        assert ops.launches()["flash_attention_bwd"] == cfg.n_layers
        runs.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                     [p.detach().clone() for p in state.params.parameters()],
                     [t.clone() for t in state.opt.m.values()],
                     [t.clone() for t in state.opt.v.values()]))
    (l0, n0, p0, m0, v0), (l1, n1, p1, m1, v1) = runs
    assert (l0, n0) == (l1, n1)
    for a, b in zip(p0 + m0 + v0, p1 + m1 + v1):
        assert torch.equal(a, b)


def test_flash_bwd_long_group_sums_round_like_float64(cuda):
    """granite-20b's MQA: 48 query heads over one KV head at S = 8,192,
    D = 128, so dK and dV sum 48 x 8,192 queries a key. At most 5% of
    their elements may lie more than half their own bf16 ulp from float64
    (chip_smoke.py's BWD_MISROUNDED_SHARE), and each within one bf16 ulp
    of its largest magnitude. With one tensor-core running sum over the
    group, 15% of them did (the kernel now adds each head's sum in IEEE
    fp32 at D <= 128)."""
    g = torch.Generator(device=cuda).manual_seed(48)
    q, k, v = _flash_inputs(g, 48, 1, 8192, 128, 1.0, torch.bfloat16, cuda)
    do = torch.randn(q.shape, generator=g, device=cuda).to(torch.bfloat16)
    kw = dict(causal=True, window=0, softcap=0.0)
    _, dq, dk, dv = _flash_grads(q, k, v, do, **kw)
    # float64, a head at a time: dK and dV summed over the heads in order
    wk = torch.zeros(k.shape, dtype=torch.float64, device=cuda)
    wv = torch.zeros_like(wk)
    for h in range(q.shape[0]):
        one = [t.double() for t in (q[h:h + 1], k, v, do[h:h + 1])]
        _, lse, o = ref.flash_attention_fwd_ref(*one[:3], **kw)
        gq, gk, gv = ref.flash_attention_bwd_ref(*one, lse, o, **kw)
        assert float((dq[h:h + 1].double() - gq).abs().max()) <= max(
            2.0 ** (np.floor(np.log2(float(gq.abs().max()))) - 7), 1e-5)
        wk += gk
        wv += gv
        del one, lse, o, gq, gk, gv
    for got, want, name in ((dk, wk, "dk"), (dv, wv, "dv")):
        _grads_hold([got], [want], torch.bfloat16)
        diff = (got.double() - want).abs()
        half_ulp = torch.exp2(torch.floor(torch.log2(want.abs())) - 8)
        share = float((diff > half_ulp).double().mean())
        assert share <= 0.05, f"{name}: {share:.3f} of the elements misrounded"


# ---------------------------------------------------------------------------
# zamba2-7b's head width (D = 112) and the SSM and hybrid families
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bh,bhk,s", [(4, 4, 1), (4, 4, 63), (4, 4, 64), (4, 4, 65),
                                      (4, 2, 127), (4, 4, 128), (4, 4, 129), (2, 2, 1000)])
def test_flash_kernels_at_d112_match_plain(cuda, bh, bhk, s):
    """Both forward kernels at D = 112, at tile edges (the fp32 kernel's 64
    query rows and 32 keys, the bf16 kernel's 128 and 64) and a ragged S:
    fp32 within 3e-4 of the plain version and 1e-4 where its lanes own
    columns the old layout dropped (96-111); bf16 within 3e-2, one bf16
    ulp of the plain version and of float64."""
    g = torch.Generator(device=cuda).manual_seed(112 + s)
    kw = dict(causal=True, window=0, softcap=0.0)
    q, k, v = _flash_inputs(g, bh, bhk, s, 112, 1.0, torch.float32, cuda)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.LAUNCHES["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(got[..., 96:], want[..., 96:], rtol=1e-4, atol=1e-4)
    _flash_bf16_holds(*(t.to(torch.bfloat16) for t in (q, k, v)), **kw)


def test_flash_bwd_at_an_unbuilt_width_raises_before_any_launch(cuda):
    q = torch.randn(2, 64, 96, device=cuda, dtype=torch.bfloat16)  # repro-lint: disable=rng-global (values unused: it raises)
    lse = torch.zeros(2, 64, device=cuda)
    ops.reset_launches()
    with pytest.raises(ValueError, match="not built for it"):
        ops.flash_attention_bwd(q, q, q, q, lse, q.float(), causal=True, window=0,
                                softcap=0.0, scale=96 ** -0.5)
    assert ops.launches()["flash_attention_bwd"] == 0


@pytest.mark.parametrize("bh,bhk,s", [(4, 4, 1), (4, 4, 31), (4, 4, 33), (4, 2, 127),
                                      (4, 4, 129), (2, 2, 1000)])
def test_flash_bwd_fp32_at_d112_matches_plain(cuda, bh, bhk, s):
    """The fp32 backward at D = 112 (zamba2-7b), whose lanes 28-31 own no
    column, at the SIMT kernels' 32-row and 32-key tile edges and a ragged
    S: within 3e-4 of each gradient's largest magnitude of float64
    (`_grads_hold`), and columns 96-111, which D / 32 columns a lane
    missed, within 1e-4 of the fp32 plain version (on the plain forward's
    lse and the kernel's output)."""
    g = torch.Generator(device=cuda).manual_seed(1120 + s)
    kw = dict(causal=True, window=0, softcap=0.0)
    q, k, v = _flash_inputs(g, bh, bhk, s, 112, 1.0, torch.float32, cuda)
    do = torch.randn(q.shape, generator=g, device=cuda)
    ops.reset_launches()
    out, *got = _flash_grads(q, k, v, do, **kw)
    torch.cuda.synchronize()
    assert ops.launches()["flash_attention_bwd"] == 1
    _grads_hold(got, _exact_grads(q, k, v, do, **kw), torch.float32)
    _, lse, _ = ref.flash_attention_fwd_ref(q, k, v, **kw)
    plain = ref.flash_attention_bwd_ref(q, k, v, do, lse, out.detach(), scale=112 ** -0.5,
                                        **kw)
    for a, b in zip(got, plain):
        torch.testing.assert_close(a[..., 96:], b[..., 96:], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["xlstm-350m", "zamba2-7b"])
def test_reduced_ssm_and_hybrid_forward_on_the_card_matches_the_cpu(cuda, name):
    """The reduced model's fp32 loss_fn and prefill logits on the card
    against the CPU plain path (S = 64: zamba's shared block takes the flash
    kernel once a group on the card), at 1e-4."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import build_model

    cfg = dataclasses.replace(reduced(get_config(name)), dtype=torch.float32,
                              param_dtype=torch.float32)
    cpu_model = build_model(cfg, device="cpu")
    params = cpu_model.init(seed=0)
    card_model = build_model(cfg, device=cuda)
    card_params = card_model.init(seed=0)
    card_params.load_state_dict(params.state_dict())
    batch = TokenStream(cfg, 2, 64, seed=1)(0)
    ops.reset_launches()
    with torch.no_grad():
        got, _ = card_model.loss_fn(card_params, batch)
        want, _ = cpu_model.loss_fn(params, batch)
    torch.cuda.synchronize()
    flash = ops.launches()["flash_attention"]
    assert flash == (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    prompt = {"tokens": batch["tokens"][:, :40]}
    torch.testing.assert_close(card_model.prefill_fn(card_params, prompt)["logits"].cpu(),
                               cpu_model.prefill_fn(params, prompt)["logits"],
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# whisper-medium's cross-attention and qwen2-vl-7b's group of 7
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sq,sk", [(256, 150), (64, 1500), (1000, 65), (130, 63), (17, 1)])
def test_flash_non_causal_ragged_keys_match_plain(cuda, sq, sk):
    """whisper's cross-attention: S_q queries over S_k keys without
    causality, S_k ragged against the fp32 kernel's 32-key and the bf16
    kernel's 64-key tiles (1,500 frames at full width), D = 64, 4 heads
    over 4: fp32 within 3e-4 of the plain version, bf16 within 3e-2 and
    one bf16 ulp of the plain version and of float64. The same inputs with
    K and V zero-padded to a multiple of 128 keys (the JAX chunked path's
    fault) give another output."""
    g = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn(4, sq, 64, generator=g, device=cuda)
    k, v = (torch.randn(4, sk, 64, generator=g, device=cuda) for _ in range(2))
    kw = dict(causal=False, window=0, softcap=0.0)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.launches()["flash_attention"] == 1 and got.shape == q.shape
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, **kw),
                               rtol=3e-4, atol=3e-4)
    _flash_bf16_holds(*(t.to(torch.bfloat16) for t in (q, k, v)), **kw)
    pad = -sk % 128
    if pad:
        kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
        assert not torch.allclose(ops.flash_attention(q, kp, vp, **kw), got,
                                  rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("s", [1, 127, 128, 129, 1000])
def test_flash_d128_group_of_7_matches_plain(cuda, s):
    """qwen2-vl-7b's attention: D = 128, causal, 14 query heads over 2 KV
    heads (a group of 7, 28 over 4 at full width), at the tile edges: fp32
    within 3e-4 of the plain version, bf16 within 3e-2 and one bf16 ulp of
    the plain version and of float64."""
    g = torch.Generator(device=cuda).manual_seed(700 + s)
    q, k, v = _flash_inputs(g, 14, 2, s, 128, 1.0, torch.float32, cuda)
    kw = dict(causal=True, window=0, softcap=0.0)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.launches()["flash_attention"] == 1
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, **kw),
                               rtol=3e-4, atol=3e-4)
    _flash_bf16_holds(*(t.to(torch.bfloat16) for t in (q, k, v)), **kw)


@pytest.mark.parametrize("name", ["whisper-medium", "qwen2-vl-7b"])
def test_reduced_audio_and_vlm_forward_on_the_card_matches_the_cpu(cuda, name):
    """The reduced model's fp32 loss_fn and prefill logits on the card
    against the CPU plain path, at 1e-4. S = 64 takes the flash kernel:
    qwen2-vl's attention (8 patches and 56 tokens) once a layer, whisper's
    self-attention and, over 40 frames (more than the chunk of 32), its
    non-causal cross-attention with a ragged tail, twice a layer."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import build_model

    cfg = dataclasses.replace(reduced(get_config(name)), dtype=torch.float32,
                              param_dtype=torch.float32)
    if cfg.family == "audio":
        cfg = dataclasses.replace(cfg, encoder_seq=40)
    cpu_model = build_model(cfg, device="cpu")
    params = cpu_model.init(seed=0)
    card_model = build_model(cfg, device=cuda)
    card_params = card_model.init(seed=0)
    card_params.load_state_dict(params.state_dict())
    n_text = 64 - cfg.n_patches
    batch = TokenStream(cfg, 2, n_text, seed=1)(0)
    ops.reset_launches()
    with torch.no_grad():
        got, _ = card_model.loss_fn(card_params, batch)
        want, _ = cpu_model.loss_fn(params, batch)
    torch.cuda.synchronize()
    per_layer = 2 if cfg.family == "audio" else 1
    assert ops.launches()["flash_attention"] == per_layer * cfg.n_layers
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    prompt["tokens"] = batch["tokens"][:, :20]
    if cfg.family == "vlm":
        prompt["positions"] = batch["positions"][:, :, :cfg.n_patches + 20]
    torch.testing.assert_close(card_model.prefill_fn(card_params, prompt)["logits"].cpu(),
                               cpu_model.prefill_fn(params, prompt)["logits"],
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the backward at S_q != S_k, whisper's training, the opt variant's paths
# ---------------------------------------------------------------------------
# S_k on both sides of the edges of the bf16 kernels' tiles (32 keys a dq
# tile, 64 a dkdv block) and of the fp32 kernels' (32), S_q no multiple of
# a tile, a group of 2, and whisper's 1,500 frames (23 x 64 + 28)
SQ_NE_SK = [
    # bh, bhk, sq, sk, d, causal, window, cap
    (4, 4, 100, 1, 64, False, 0, 0.0),
    (4, 2, 130, 15, 64, False, 0, 50.0),
    (4, 4, 129, 63, 32, False, 0, 0.0),
    (4, 4, 127, 64, 64, False, 0, 0.0),
    (4, 2, 200, 65, 128, False, 0, 30.0),
    (4, 4, 300, 1500, 64, False, 0, 0.0),
    (4, 2, 70, 40, 64, True, 0, 30.0),        # causal, S_k < S_q
    (4, 2, 40, 70, 256, True, 16, 50.0),      # causal window, S_k > S_q
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bh,bhk,sq,sk,d,causal,window,cap", SQ_NE_SK)
def test_flash_bwd_at_sq_ne_sk(cuda, dtype, bh, bhk, sq, sk, d, causal, window, cap):
    """The backward at S_q != S_k in both dtypes against the float64 plain
    version (`_grads_hold`), one launch, and two runs to the same bits."""
    g = torch.Generator(device=cuda).manual_seed(bh + sq + 3 * sk + d)
    q = torch.randn(bh, sq, d, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(bhk, sk, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    do = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, softcap=cap)
    ops.reset_launches()
    first = _flash_grads(q, k, v, do, **kw)
    torch.cuda.synchronize()
    assert ops.launches()["flash_attention_bwd"] == 1
    _grads_hold(first[1:], _exact_grads(q, k, v, do, **kw), dtype)
    again = _flash_grads(q, k, v, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_whisper_full_width_train_step_on_the_card(cuda):
    """One make_train_step of whisper-medium at its published widths, B =
    1, S = 8,192 decoder tokens over 1,500 frames, remat on: 96 flash
    forward launches (a self- and a cross-attention a layer, each again in
    the recompute) and 48 backward launches, a finite loss and grad_norm."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig

    cfg = get_config("whisper-medium")
    opt = AdamWConfig()
    state = init_train_state(cfg, 0, opt)
    step = make_train_step(cfg, opt)
    batch = TokenStream(cfg, 1, 8192, seed=0)(0)
    ops.reset_launches()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    n = ops.launches()
    assert n["flash_attention"] == 4 * cfg.n_layers and n["flash_attention_bwd"] == 2 * cfg.n_layers
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))


def test_grouped_moe_at_one_sequence_is_the_global_dispatch_on_the_card(cuda):
    """moe_block of reduced granite-moe-3b-a800m in bf16 at B = 1 under
    moe_group_dispatch (one group) against the global dispatch on the card:
    out, aux and every gradient bit for bit."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import layers

    cfg = dataclasses.replace(reduced(get_config("granite-moe-3b-a800m")), capacity_factor=1.0)
    moe = layers.init_moe(cfg, generator=torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    x = torch.randn(1, 64, cfg.d_model, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda).to(torch.bfloat16)
    got = []
    for group in (False, True):
        for p in moe.parameters():
            p.grad = None
        xd = x.detach().clone().requires_grad_()
        out, aux = layers.moe_block(moe, xd, dataclasses.replace(cfg, moe_group_dispatch=group))
        (out.float().square().sum() + aux).backward()
        got.append([out.detach(), aux.detach(), xd.grad] + [p.grad for p in moe.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*got))


def test_dots_step_launches_no_flash_forward_in_its_backward(cuda):
    """make_train_step of reduced gemma2-2b (S = 64: the flash kernels in
    every layer) under remat policies "nothing" and "dots": "nothing"
    launches the flash forward twice a layer (forward and recompute),
    "dots" once, which it keeps; both launch the backward once a layer and
    give the same loss and grad_norm bit for bit."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig

    base = dataclasses.replace(reduced(get_config("gemma2-2b")), remat=True)
    opt = AdamWConfig(lr=1e-3)
    batch = TokenStream(base, 2, 64, seed=0)(0)
    out = {}
    for policy in ("nothing", "dots"):
        cfg = dataclasses.replace(base, remat_policy=policy)
        state = init_train_state(cfg, 0, opt, device=cuda)
        ops.reset_launches()
        state, m = make_train_step(cfg, opt, total_steps=5, device=cuda)(state, batch)
        torch.cuda.synchronize()
        out[policy] = (ops.launches(), float(m["loss"]), float(m["grad_norm"]))
    n = base.n_layers
    assert out["nothing"][0]["flash_attention"] == 2 * n
    assert out["dots"][0]["flash_attention"] == n
    assert out["nothing"][0]["flash_attention_bwd"] == out["dots"][0]["flash_attention_bwd"] == n
    assert out["nothing"][1:] == out["dots"][1:]


def test_each_kernel_is_one_dispatcher_op_whose_fake_has_the_kernels_shapes(cuda):
    """Each kernel's op on CUDA tensors launches its kernel once (one count
    in ops.LAUNCHES) and gives outputs of the shapes and dtypes its fake
    gives on the meta device; a cost counter sees each as one op."""
    from repro_torch.launch.cost import CostCounter

    g = torch.Generator(device=cuda).manual_seed(3)
    r, w, n, k = 12, 5, 40, 64
    idx = torch.randint(0, n, (r, w), generator=g, device=cuda, dtype=torch.int32)
    val = torch.randn((r, w), generator=g, device=cuda)
    msk = (torch.rand((r, w), generator=g, device=cuda) > 0.3).float()
    seg = torch.tensor([0, 0, 1, 1, 1, 2, 3, 3, 4, 5, 5, 5], dtype=torch.int32, device=cuda)
    ptr = torch.tensor(ops.segment_offsets(seg.cpu().numpy(), 6), device=cuda)
    v = torch.randn((2, n, k), generator=g, device=cuda)
    a = torch.randn((r, k, k), generator=g, device=cuda)
    prec = a @ a.transpose(1, 2) + k * torch.eye(k, device=cuda)
    q = torch.randn((4, 256, 64), generator=g, device=cuda).bfloat16()
    kv = torch.randn((2, 256, 64), generator=g, device=cuda).bfloat16()
    _, lse, o32 = ops.flash_forward(q, kv, kv, True, 0, 0.0, 0.125, True)
    calls = [
        ("gather_syrk_seg", torch.ops.repro_torch.gather_syrk_seg,
         (idx, val, msk, seg, 6, v, False, False, ptr)),
        ("masked_syrk", torch.ops.repro_torch.masked_syrk,
         (torch.randn((r, w, k), generator=g, device=cuda), val)),
        ("chol_solve_sample", torch.ops.repro_torch.chol_solve_sample,
         (prec, torch.randn((r, k), generator=g, device=cuda),
          torch.randn((r, k), generator=g, device=cuda))),
        ("topn_scores", torch.ops.repro_torch.topn_scores,
         (torch.randn((6, k), generator=g, device=cuda), v[0], 7, None)),
        ("flash_attention", torch.ops.repro_torch.flash_forward,
         (q, kv, kv, True, 0, 0.0, 0.125, False)),
        ("flash_attention_bwd", torch.ops.repro_torch.flash_attention_bwd,
         (q, kv, kv, q, lse, o32, True, 0, 0.0, 0.125)),
    ]
    for name, op, args in calls:
        ops.reset_launches()
        with CostCounter() as counter:
            real = op(*args)
        torch.cuda.synchronize()
        assert ops.launches()[name] == 1 and sum(ops.launches().values()) == 1, name
        assert counter.n_ops == 1 and counter.flops > 0, name
        fake = op(*(t.to("meta") if isinstance(t, torch.Tensor) else t for t in args))
        assert [(t.shape, t.dtype) for t in real] == [(t.shape, t.dtype) for t in fake], name
    assert sum(ops.launches().values()) == 1          # the fakes launched nothing


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,window,cap,n_shards", [
    (True, 4096, 50.0, 16),     # gemma2-2b's local layers, 16 shards
    (True, 0, 50.0, 16),        # and its global ones
    (True, 100, 30.0, 3),       # offsets off the query blocks
    (False, 0, 0.0, 4),         # a cross-attention's queries over all keys
])
def test_flash_pair_with_query_offsets(cuda, dtype, causal, window, cap, n_shards):
    """Q split into shards at their offsets over the same K and V: each
    shard's forward and backward against the plain versions at their
    offset, and the shards joined against the whole launch: the rows, lse
    and dQ bit for bit where every offset is a multiple of the kernels'
    query blocks (128 rows: BQ and DQ_BQ), else at the forward's and the
    backward's gates; dK and dV summed over the shards at the backward's."""
    s = 2048 if n_shards != 3 else 600
    g = torch.Generator(device=cuda).manual_seed(s + n_shards)
    q, k, v = _flash_inputs(g, 8, 4, s, 128, 1.0, dtype, cuda)
    do = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, *whole = _flash_grads(q, k, v, do, **kw)
    step = -(-s // n_shards)
    bounds = [(lo, min(lo + step, s)) for lo in range(0, s, step)]
    aligned = all(lo % 128 == 0 for lo, _ in bounds)
    outs, dqs, dk, dv = [], [], 0.0, 0.0
    tol = 3e-4 if dtype == torch.float32 else 3e-2
    for lo, hi in bounds:
        part = q[:, lo:hi].contiguous()
        o, *gr = _flash_grads(part, k, v, do[:, lo:hi].contiguous(), q_offset=lo, **kw)
        want = ref.flash_attention_ref(part, k, v, q_offset=lo, **kw)
        torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)
        qd, kd, vd, dod = (t.double() for t in (part, k, v, do[:, lo:hi]))
        _, lse, of = ref.flash_attention_fwd_ref(qd, kd, vd, q_offset=lo, **kw)
        _grads_hold(gr, ref.flash_attention_bwd_ref(qd, kd, vd, dod, lse, of, q_offset=lo,
                                                    **kw), dtype)
        outs.append(o)
        dqs.append(gr[0])
        dk, dv = dk + gr[1].double(), dv + gr[2].double()
    joined, jdq = torch.cat(outs, 1), torch.cat(dqs, 1)
    if aligned:
        assert torch.equal(joined, out) and torch.equal(jdq, whole[0])
    else:
        torch.testing.assert_close(joined.float(), out.float(), rtol=tol, atol=tol)
    _grads_hold((jdq, dk.to(dtype), dv.to(dtype)),
                tuple(w.double() for w in whole), dtype)


# ---------------------------------------------------------------------------
# the serving tier placed over devices
# ---------------------------------------------------------------------------
def _tier_ensemble(device):
    from repro_torch.serve import PosteriorEnsemble

    rng = np.random.default_rng(5)
    s, m, n, k = 3, 300, 1000, 16
    return PosteriorEnsemble.from_arrays(
        rng.normal(size=(s, m, k)).astype(np.float32),
        rng.normal(size=(s, n, k)).astype(np.float32),
        hyper_u_mu=np.zeros((s, k), np.float32), hyper_u_lam=np.tile(np.eye(k), (s, 1, 1)),
        hyper_v_mu=np.zeros((s, k), np.float32), hyper_v_lam=np.tile(np.eye(k), (s, 1, 1)),
        global_mean=3.25, alpha=2.0, steps=[1, 2, 3], device=device)


def _tier_calls(single):
    users = np.arange(64, dtype=np.int32)
    exclude = [np.arange(r, r + 5, dtype=np.int32) for r in range(16)]
    rows = single.u_flat[:16]
    return [lambda r: r.recommend(users, 10),
            lambda r: r.recommend_rows(rows, 7, exclude=exclude, fetch_hint=32)]


def test_card_and_host_tier_gathers_its_candidates_onto_the_card(cuda):
    """Hosts on cuda:0 and on the CPU: the CPU shards score with the plain
    version, every shard's candidates go to cuda:0 and merge there. Kernel
    and plain version agree to the bit, so the tier is bit for bit the
    single host on the card, with one top-N launch a card shard."""
    from repro_torch.serve import ClusterCoordinator, TopNRecommender

    ens = _tier_ensemble(cuda)
    tier = ClusterCoordinator(ens, devices=["cuda:0", "cpu", "cuda:0", "cpu"])
    single = TopNRecommender(ens)
    assert tier.device == torch.device("cuda", 0)
    assert [h.live.v_shard.device.type for h in tier.hosts] == ["cuda", "cpu"] * 2
    for call in _tier_calls(single):
        ops.reset_launches()
        got = call(tier)
        assert ops.launches()["topn_scores"] == 2
        for a, b in zip(got, call(single)):
            assert np.array_equal(a, b)


def test_tier_on_two_cards_is_the_single_host(cuda):
    """devices=["cuda:0", "cuda:1"]: each host's tables and launches on its
    own card, the candidates gathered onto cuda:0; bit for bit the single
    host. Skips with fewer than two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.serve import ClusterCoordinator, TopNRecommender

    ens = _tier_ensemble(cuda)
    tier = ClusterCoordinator(ens, devices=["cuda:0", "cuda:1"], replicas=1)
    single = TopNRecommender(ens)
    assert [h.live.v_shard.device for h in tier.hosts] == [torch.device("cuda", i)
                                                           for i in (0, 1)]
    for call in _tier_calls(single):
        ops.reset_launches()
        got = call(tier)
        assert ops.launches()["topn_scores"] == 2
        for a, b in zip(got, call(single)):
            assert np.array_equal(a, b)
