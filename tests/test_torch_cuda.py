"""Each CUDA kernel against its plain PyTorch version on the card.

These tests need an NVIDIA GPU with nvcc (the kernels have no CPU mode):
they carry the `cuda` marker and skip without a card. This file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances, and why:
  * gather_syrk_seg / masked_syrk: rtol 1e-4, atol 1e-3, the JAX kernel
    tests' own (tests/test_kernels.py:171). Kernel and plain version both
    sum each row over W in order in fp64 and round once (the segment sums
    of the plain version take index_add_'s order), so they agree to the
    last bit or nearly; against a float64 evaluation the kernel's error is
    at most the plain version's.
  * chol_solve_sample: rtol 2e-3, atol 2e-3 (tests/test_kernels.py:56).
  * topn_scores: equal bit for bit; kernel and plain version sum the
    products in the same order with the same roundings.
  * flash_attention: 3e-4 in fp32 and 3e-2 in bf16, the JAX kernel tests'
    own (tests/test_kernels.py:88, 91); both sum in fp32 in another order.
    3e-2 is as large as the outputs of N(0,1) inputs over long sequences,
    so bf16 results are also held to one bf16 ulp of the value (rtol
    2^-7, atol 1e-5): kernel and plain version both compute in fp32 and
    round the output to bf16 once. The peaked case (q x 6) makes the
    softcap and each key count.

The BPMF kernels are instantiated for K = 16, 32 and 64; the cases run
every rank the repo uses (8, 16, 24, 32, 64), the others through the
wrappers' padding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(bk, bp, rtol=1e-4, atol=1e-3)
    if not bf16:
        idx, val, msk, seg = args
        p64, _ = ref.gather_syrk_seg_ref(idx, val.double(), msk.double(), seg, n_seg,
                                         v.double(), **kw)
        assert (pk.double() - p64).abs().max() <= (pp.double() - p64).abs().max()


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
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
    a = torch.randn(37, k, k, generator=g, device=cuda)
    prec = a @ a.transpose(1, 2) + (0.1 * k + 0.6) * torch.eye(k, device=cuda)
    rhs = torch.randn(37, k, generator=g, device=cuda)
    z = torch.randn(37, k, generator=g, device=cuda)
    x = ops.chol_solve_sample(prec, rhs, z)
    assert x.shape == (37, k)
    torch.testing.assert_close(x, ref.chol_solve_sample_ref(prec, rhs, z),
                               rtol=2e-3, atol=2e-3)
    assert ops.LAUNCHES["masked_syrk"] == ops.LAUNCHES["chol_solve_sample"] == 1


@pytest.mark.parametrize("k", RANKS)
def test_chol_kernel_not_positive_definite_matches_plain(cuda, k):
    eye = torch.eye(k, device=cuda)
    bad = torch.stack([-eye, eye * torch.linspace(-1, 1, k, device=cuda), 2 * eye])
    ones = torch.ones(3, k, device=cuda)
    xk = ops.chol_solve_sample(bad, ones, ones)
    xp = ref.chol_solve_sample_ref(bad, ones, ones)
    fin = torch.isfinite(xp)
    assert torch.equal(torch.isfinite(xk), fin)
    torch.testing.assert_close(xk[fin], xp[fin], rtol=2e-3, atol=2e-3)


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
    with pytest.raises(RuntimeError):                                  # no backward
        ops.flash_attention(q.requires_grad_(), q.detach(), q.detach())
