"""The port's LM training path against the JAX package on the CPU.

Inputs, parameters, gradients and optimiser states come from numpy under a
seed and go through both packages (the JAX parameters and AdamW state are
carried across with `params_from_numpy` and `optim.opt_state_from_numpy`). On the
CPU `ops.flash_attention` with grad runs the autograd Function
`FlashAttention` with its plain versions (`ref.flash_attention_fwd_ref`,
`ref.flash_attention_bwd_ref`); the CUDA backward kernel is held against
those on the card (tests/test_torch_cuda.py, chip_smoke.py). The JAX
gradient of the flash path is `jax.grad` through the chunked scan that JAX
trains through (`multi_head_attention(chunk=)`) and through its direct
oracle (`repro.kernels.ref.flash_attention_ref`).

Tolerances, and why:
  * flash gradients in fp32: rtol 1e-4 and an atol of 1e-5 of the
    gradient's largest magnitude. Both compute in fp32 and sum in other
    orders (the scan over 32-key chunks, einsums); the largest reading is
    6.3e-7 of the largest magnitude.
  * flash gradients in bf16: one bf16 ulp of each gradient's largest
    magnitude (atol 2^-7 of it), rtol 2^-7: both compute in fp32 from the
    same bf16 inputs and round each gradient to bf16 once, so they may
    differ by one rounding of each entry (largest reading 0.0055 of it).
  * the reduced gemma2-2b gradients in fp32: rtol 1e-4 and an atol of 1e-5
    of each parameter's largest gradient magnitude: the same fp32
    arithmetic through 2 layers, summed in other orders (largest reading
    1.4e-6 of it).
  * AdamW and clipping in fp32: rtol 1e-6, atol 1e-7, the same fp32
    operations in the same order; in bf16 the parameters within one bf16
    ulp (rtol 2^-8), the moments as in fp32. The global norm at rtol 1e-5:
    an fp32 sum of some 400,000 squares, taken in another order (1.4e-6
    apart in bf16).
  * one AdamW step over the reduced xLSTM, Zamba2, whisper and Qwen2-VL
    trees in fp32: rtol 1e-6 and atol 5e-7, one fp32 ulp of the update's
    operands (p and lr delta, up to about 4 in magnitude), which cancel
    where the new parameter is small: 1 of whisper's 4.2 million
    `dec_pos` entries lands 1.2e-7 from JAX's at 8.4e-3 (XLA's CPU code
    may fuse the multiply and the subtract); the moments as the gemma2-2b
    step's.
  * three training steps in fp32 (gemma2-2b's and the xLSTM's): loss,
    grad_norm and lr at rtol 1e-5; the parameters at rtol 1e-4 and atol
    1e-6. The xLSTM's steps take Adam's eps at 1e-3 in both packages (and a
    weight decay of 0.5, so that the decay of its stacked 1-D leaves shows
    above that atol): at init some of its gradients lie within the two
    packages' fp32 noise of zero (the sLSTM's gate biases, about 1e-11),
    and at eps 1e-8 m / (sqrt(v) + eps) makes a step of up to lr out of
    that noise (7% of one sLSTM's gate biases landed 5e-6 from JAX's);
    at 1e-3 such a step stays linear in its gradient. An AdamW step moves each
    entry by about lr m / sqrt(v); the first steps' updates are about lr
    times the sign of the gradient, which the two packages agree on
    wherever the gradient is above their fp32 noise.
  * remat on and off: equal bit for bit (the same operations, recomputed).
"""
import dataclasses
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

from repro.configs import get_config as jget_config, reduced as jreduced  # noqa: E402
from repro.data.tokens import TokenStream as JTokenStream  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import DecoderModel, params_from_numpy  # noqa: E402
from repro_torch.models import layers as tl, transformer as tt  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.runtime.trainer import state_arrays  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_to_max(got, want, *, rtol, frac):
    """allclose with an atol of `frac` of want's largest magnitude."""
    got, want = _np(got), _np(want)
    atol = frac * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _grad_tol(name):
    return (dict(rtol=1e-4, frac=1e-5) if name == "fp32"
            else dict(rtol=2.0 ** -7, frac=2.0 ** -7))


# ---------------------------------------------------------------------------
# flash-attention gradients
# ---------------------------------------------------------------------------
FLASH_CASES = [
    # bh, bhk, s, d, window, cap, dtype
    (8, 4, 64, 32, 0, 0.0, "fp32"),       # GQA: two query heads a KV head
    (8, 4, 64, 32, 16, 50.0, "fp32"),
    (2, 2, 72, 64, 0, 50.0, "fp32"),      # ragged S against chunk 32
    (4, 2, 72, 32, 16, 0.0, "fp32"),
    (8, 4, 64, 64, 16, 50.0, "bf16"),
    (2, 1, 72, 32, 0, 50.0, "bf16"),
    (4, 2, 72, 112, 0, 0.0, "fp32"),      # zamba2-7b's head width, ragged S
    (4, 2, 72, 112, 16, 50.0, "bf16"),
]


@pytest.mark.parametrize("bh,bhk,s,d,window,cap,name", FLASH_CASES)
def test_flash_gradients_match_jax(bh, bhk, s, d, window, cap, name):
    """The port's FlashAttention (the plain versions on the CPU) against
    jax.grad through the chunked scan and through the direct oracle."""
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(bh + s + d + window)
    q = rng.normal(size=(bh, s, d)).astype(np.float32)
    k, v = (rng.normal(size=(bhk, s, d)).astype(np.float32) for _ in range(2))
    do = rng.normal(size=(bh, s, d)).astype(np.float32)
    rep = bh // bhk
    kw = dict(causal=True, window=window, softcap=cap)

    tq, tk, tv = (torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v))
    ops.reset_launches()
    out = ops.flash_attention(tq, tk, tv, **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(do).to(tdt))
    assert sum(ops.launches().values()) == 0          # the plain versions
    assert all(g.dtype == tdt for g in got)

    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))

    def chunked(q, k, v):      # (BH, S, D) as (1, S, BH, D), the model's layout
        out = jl.multi_head_attention(
            q.transpose(1, 0, 2)[None], k.transpose(1, 0, 2)[None],
            v.transpose(1, 0, 2)[None], causal=True, window=window,
            attn_softcap=cap, chunk=32)[0].transpose(1, 0, 2)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    def oracle(q, k, v):
        out = jref.flash_attention_ref(q, jnp.repeat(k, rep, axis=0),
                                       jnp.repeat(v, rep, axis=0), **kw)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    tol = _grad_tol(name)
    for fn in (chunked, oracle):
        want = jax.jit(jax.grad(fn, argnums=(0, 1, 2)))(jq, jk, jv)
        for g, w, what in zip(got, want, "qkv"):
            assert g.shape == w.shape, what
            _close_to_max(g, w, **tol)


@pytest.mark.parametrize("causal,s,window,cap", [
    (True, 7, 3, 5.0), (True, 9, 0, 0.0), (False, 16, 4, 2.0)])
def test_flash_bwd_ref_gradcheck(causal, s, window, cap):
    """flash_attention_bwd_ref in float64 against finite differences of the
    plain forward, through FlashAttention, with GQA."""
    g = torch.Generator().manual_seed(s)
    q = torch.randn(4, s, 8, generator=g, dtype=torch.float64, requires_grad=True)
    k, v = (torch.randn(2, s, 8, generator=g, dtype=torch.float64, requires_grad=True)
            for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, causal=causal, window=window,
                                            softcap=cap), (q, k, v))


def test_flash_forward_with_grad_keeps_the_forward_and_the_lse():
    """With grad, the forward's output is the no-grad output bit for bit,
    and the lse it keeps is each row's log-sum-exp."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.normal(size=(4, 40, 32)).astype(np.float32))
               for _ in range(3))
    kw = dict(causal=True, window=8, softcap=30.0)
    plain = ops.flash_attention(q, k, v, **kw)
    out, lse, o = ref.flash_attention_fwd_ref(q, k, v, **kw)
    assert torch.equal(out, plain) and torch.equal(o, plain)
    s = torch.tanh(torch.einsum("bqd,bkd->bqk", q, k) / np.sqrt(32) / 30.0) * 30.0
    pos = torch.arange(40)
    seen = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < 8)
    want = torch.logsumexp(s.masked_fill(~seen, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)
    with_grad = ops.flash_attention(q.requires_grad_(), k, v, **kw)
    assert torch.equal(with_grad.detach(), plain)


# ---------------------------------------------------------------------------
# the reduced model's gradients
# ---------------------------------------------------------------------------
def _models(name, **over):
    jdt, tdt = DTYPES[name]
    jcfg = dataclasses.replace(jreduced(jget_config("gemma2-2b")), dtype=jdt,
                               param_dtype=jdt, **over)
    tcfg = dataclasses.replace(reduced(get_config("gemma2-2b")), dtype=tdt,
                               param_dtype=tdt, **over)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jmodel, jparams, DecoderModel(tcfg, device="cpu"), tparams


def _port_leaf(jtree, name):
    """The slice of a JAX tree (layers stacked) that port parameter `name` is."""
    return tt.param_leaf(jtree, name)[1]


@pytest.mark.parametrize("path,seq", [("flash", 64), ("direct", 32)])
def test_reduced_gemma2_gradients_match_jax(path, seq, monkeypatch):
    """jax.grad(model.loss_fn) against the port's loss.backward() in fp32,
    on the flash path (S >= chunked_attn_min_len = 64: FlashAttention in
    every layer) and on the direct path (matmul_f32 through autograd)."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models("fp32")
    batch = TokenStream(tcfg, 2, seq, seed=4)(0)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    loss, _ = tmodel.loss_fn(tparams, batch)
    loss.backward()
    assert len(calls) == (tcfg.n_layers if path == "flash" else 0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for name, p in tparams.named_parameters():
        _close_to_max(p.grad, _port_leaf(jgrads, name), **_grad_tol("fp32"))


def test_logit_softcap_backpropagates_on_the_cpu():
    """The in-place logit softcap stays out of autograd: backward through
    decoder_forward's logits of a reduced bf16 model whose logit_softcap >
    0 runs, and gives loss_fn's gradients (its chunked head) within bf16
    rounding; the no-grad logits are the same numbers."""
    cfg = reduced(get_config("gemma2-2b"))
    assert cfg.logit_softcap > 0
    model = DecoderModel(cfg, device="cpu")
    params = model.init(seed=0)
    batch = TokenStream(cfg, 2, 32, seed=0)(0)
    tokens = torch.as_tensor(batch["tokens"])
    positions = torch.arange(32, dtype=torch.int32).expand(2, 32)
    logits = tt.decoder_forward(params, cfg, tokens, positions=positions)[0]
    loss, _ = tt.cross_entropy(logits, torch.as_tensor(batch["labels"]))
    loss.backward()
    grads = {n: p.grad for n, p in params.named_parameters()}
    assert all(g is not None and torch.isfinite(g).all() for g in grads.values())
    with torch.no_grad():
        assert torch.equal(tt.decoder_forward(params, cfg, tokens, positions=positions)[0],
                           logits)
    for p in params.parameters():
        p.grad = None
    head, _ = model.loss_fn(params, batch)
    head.backward()
    assert float(head) == float(loss)          # one chunk: the same arithmetic
    for n, p in params.named_parameters():
        _close_to_max(p.grad, grads[n], rtol=2.0 ** -7, frac=2.0 ** -7)


@pytest.mark.parametrize("chunk", [7, 64])
def test_head_loss_in_chunks_is_the_whole_heads(chunk, monkeypatch):
    """HeadLoss over chunks of 7 rows (and in one chunk) against autograd
    through decoder_forward + cross_entropy in fp32, some labels invalid:
    the loss at rtol 1e-6 and h's and the embedding's gradients at rtol
    1e-5, an atol of 1e-6 of their largest magnitude: the same fp32
    arithmetic, summed in chunks."""
    monkeypatch.setattr(tt, "HEAD_CHUNK", chunk)
    cfg = dataclasses.replace(reduced(get_config("gemma2-2b")), dtype=torch.float32,
                              param_dtype=torch.float32)
    params = DecoderModel(cfg, device="cpu").init(seed=3)
    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 20, cfg.d_model, generator=g)
    labels = torch.randint(0, cfg.vocab_size, (2, 20), generator=g)
    labels[0, :3] = -1
    out = {}
    for name in ("chunks", "whole"):
        hh = h.clone().requires_grad_()
        params.embed.grad = None
        if name == "chunks":
            loss, _ = tt.head_loss(params, cfg, hh, labels)
        else:
            logits = tt.matmul_f32(hh, params.embed.t())
            logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
            loss, _ = tt.cross_entropy(logits, labels)
        loss.backward()
        out[name] = (loss.detach(), hh.grad, params.embed.grad.clone())
    np.testing.assert_allclose(float(out["chunks"][0]), float(out["whole"][0]), rtol=1e-6)
    for a, b in zip(out["chunks"][1:], out["whole"][1:]):
        _close_to_max(a, b, rtol=1e-5, frac=1e-6)


def test_head_loss_gradcheck(monkeypatch):
    """HeadLoss's backward in float64 against finite differences, over
    chunks of 3 rows, with a softcap and an invalid label."""
    monkeypatch.setattr(tt, "HEAD_CHUNK", 3)
    g = torch.Generator().manual_seed(1)
    h = torch.randn(8, 5, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(11, 5, generator=g, dtype=torch.float64, requires_grad=True)
    labels = torch.randint(0, 11, (8,), generator=g)
    labels[4] = -1
    assert torch.autograd.gradcheck(lambda h, w: tt.HeadLoss.apply(h, w, labels, 2.0),
                                    (h, w))


@pytest.mark.parametrize("seq", [64, 32])
def test_remat_gradients_are_bit_equal(seq):
    """Layers under torch.utils.checkpoint (remat) give the gradients of the
    same layers without it, bit for bit, on both attention paths."""
    cfg = dataclasses.replace(reduced(get_config("gemma2-2b")), dtype=torch.float32,
                              param_dtype=torch.float32)
    params = DecoderModel(cfg, device="cpu").init(seed=1)
    batch = TokenStream(cfg, 2, seq, seed=2)(0)
    grads = {}
    for remat in (False, True):
        for p in params.parameters():
            p.grad = None
        model = DecoderModel(dataclasses.replace(cfg, remat=remat), device="cpu")
        loss, _ = model.loss_fn(params, batch)
        loss.backward()
        grads[remat] = (float(loss), {n: p.grad.clone() for n, p in params.named_parameters()})
    assert grads[True][0] == grads[False][0]
    for name, g in grads[False][1].items():
        assert torch.equal(g, grads[True][1][name]), name


class _OpCounts(TorchDispatchMode):
    """The dispatcher ops run under it, by name."""

    def __init__(self):
        super().__init__()
        self.n: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _policy_run(cfg, params, batch, policy, monkeypatch):
    """loss, gradients, the bytes the policy kept (beside the layers'
    inputs), and the backward's matrix products and flash forwards."""
    kept = [0]
    real = tt.REMAT_POLICIES[policy]
    if real is not None:
        def counting(ctx, op, *args, **kwargs):
            out = real(ctx, op, *args, **kwargs)
            if out in (True, torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE):
                outs = ctx.op_output if isinstance(ctx.op_output, (tuple, list)) \
                    else [ctx.op_output]
                kept[0] += sum(t.numel() * t.element_size() for t in outs)
            return out
        monkeypatch.setitem(tt.REMAT_POLICIES, policy, counting)
    for p in params.parameters():
        p.grad = None
    model = DecoderModel(dataclasses.replace(cfg, remat=True, remat_policy=policy),
                         device="cpu")
    loss, _ = model.loss_fn(params, batch)
    counts = _OpCounts()
    with counts:
        loss.backward()
    monkeypatch.setitem(tt.REMAT_POLICIES, policy, real)
    grads = {n: p.grad.clone() for n, p in params.named_parameters()}
    gemms = counts.n.get("mm", 0) + counts.n.get("bmm", 0) + counts.n.get("addmm", 0)
    return float(loss.detach()), grads, kept[0], gemms, counts.n.get("flash_forward", 0)


def test_remat_policies_not_ported_raise():
    """Named when "dots" and "attn_probs" raised under grad: both are
    ported now, so each runs with grad at reduced gemma2-2b's bf16 (S = 16,
    the direct path) to the loss and gradients of "nothing" bit for bit,
    and without grad, where nothing is recomputed, to the same loss."""
    cfg = reduced(get_config("gemma2-2b"))
    params = DecoderModel(cfg, device="cpu").init(seed=0)
    batch = TokenStream(cfg, 1, 16, seed=0)(0)
    runs = {}
    for policy in ("nothing", "dots", "attn_probs"):
        model = DecoderModel(dataclasses.replace(cfg, remat=True, remat_policy=policy),
                             device="cpu")
        for p in params.parameters():
            p.grad = None
        loss, _ = model.loss_fn(params, batch)
        loss.backward()
        with torch.no_grad():
            plain = model.loss_fn(params, batch)[0]
        assert torch.equal(plain, loss.detach())
        runs[policy] = [loss.detach()] + [p.grad.clone() for p in params.parameters()]
    for policy in ("dots", "attn_probs"):
        assert all(torch.equal(a, b) for a, b in zip(runs["nothing"], runs[policy])), policy


@pytest.mark.parametrize("name", ["fp32", "bf16"])
@pytest.mark.parametrize("seq", [64, 32])
def test_remat_policies_give_equal_gradients_and_keep_what_they_name(seq, name,
                                                                     monkeypatch):
    """The three remat policies under torch.utils.checkpoint give the same
    loss and gradients bit for bit, on both attention paths. "dots" keeps
    every product's output and the flash forward's, so its backward
    recomputes no product of the forward and launches no flash forward;
    "attn_probs" keeps only the direct path's probabilities: on the flash
    path (S = 64) nothing, as "nothing"; on the direct path (S = 32) the
    (B, H, S, S) tensor of each layer, fewer bytes than "dots" keeps."""
    _, tdt = DTYPES[name]
    cfg = dataclasses.replace(reduced(get_config("gemma2-2b")), dtype=tdt, param_dtype=tdt)
    params = DecoderModel(cfg, device="cpu").init(seed=1)
    batch = TokenStream(cfg, 2, seq, seed=2)(0)
    runs = {p: _policy_run(cfg, params, batch, p, monkeypatch)
            for p in ("nothing", "attn_probs", "dots")}
    loss, grads = runs["nothing"][:2]
    for policy, (l2, g2, *_) in runs.items():
        assert l2 == loss, policy
        for n, g in grads.items():
            assert torch.equal(g, g2[n]), (policy, n)
    kept = {p: r[2] for p, r in runs.items()}
    gemms = {p: r[3] for p, r in runs.items()}
    flash = {p: r[4] for p, r in runs.items()}
    probs = cfg.n_layers * 2 * cfg.n_heads * seq * seq * tdt.itemsize
    assert kept["nothing"] == 0 and kept["dots"] > 0
    assert kept["attn_probs"] == (0 if seq == 64 else probs) <= kept["dots"]
    # the forward's products are recomputed under "nothing" and
    # "attn_probs" (the softmax's backward needs the recomputed scores)
    assert gemms["dots"] < gemms["attn_probs"] == gemms["nothing"]
    assert flash == ({"nothing": 2, "attn_probs": 2, "dots": 0} if seq == 64
                     else dict.fromkeys(runs, 0))


@pytest.mark.parametrize("policy", ["dots", "attn_probs"])
@pytest.mark.parametrize("seq", [64, 32])
def test_remat_policy_gradients_match_jax(seq, policy):
    """The reduced gemma2-2b's gradients in fp32 under remat with each
    policy against jax.grad under the same policy (the flash path at S =
    64, the direct at 32), at the reduced model's gradient tolerance."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models(
        "fp32", remat=True, remat_policy=policy)
    batch = TokenStream(tcfg, 2, seq, seed=3)(0)
    loss, _ = tmodel.loss_fn(tparams, batch)
    loss.backward()
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for n, p in tparams.named_parameters():
        _close_to_max(p.grad, _port_leaf(jgrads, n), rtol=1e-4, frac=1e-5)


def test_an_unknown_remat_policy_raises():
    cfg = dataclasses.replace(reduced(get_config("gemma2-2b")), remat=True,
                              remat_policy="everything")
    params = DecoderModel(cfg, device="cpu").init(seed=0)
    with pytest.raises(ValueError, match="remat_policy"):
        DecoderModel(cfg, device="cpu").loss_fn(params, TokenStream(cfg, 1, 16, seed=0)(0))


# ---------------------------------------------------------------------------
# the optimiser
# ---------------------------------------------------------------------------
def _random_tree(rng, shapes, positive=False):
    def leaf(sd):
        x = rng.normal(size=sd.shape).astype(np.float32)
        return np.abs(x) if positive else x
    return jax.tree.map(leaf, shapes)


@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_clip_and_adamw_match_jax(name):
    """clip_by_global_norm and adamw_update against the JAX package on a
    random state of the reduced model's shapes, every norm scale nonzero,
    with a large lr and decay so the stacked-layer decay rule shows."""
    jdt, tdt = DTYPES[name]
    jcfg = dataclasses.replace(jreduced(jget_config("gemma2-2b")), param_dtype=jdt)
    tcfg = dataclasses.replace(reduced(get_config("gemma2-2b")), param_dtype=tdt)
    shapes = jax.eval_shape(lambda: jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    params, grads, m = (_random_tree(rng, shapes) for _ in range(3))
    v = _random_tree(rng, shapes, positive=True)
    grads = jax.tree.map(lambda g: 3.0 * g, grads)      # global norm well above 1
    opt = jadamw.AdamWConfig(lr=0.05, weight_decay=0.5)
    jstate = jadamw.AdamWState(m=jax.tree.map(jnp.asarray, m),
                               v=jax.tree.map(jnp.asarray, v), step=jnp.asarray(4, jnp.int32))
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), params)
    jg = jax.tree.map(lambda x: jnp.asarray(x, jdt), grads)

    tparams = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    tgrads = {n: torch.tensor(np.asarray(_port_leaf(jg, n), np.float32)).to(tdt)
              for n, _ in tparams.named_parameters()}
    tstate = tadamw.opt_state_from_numpy(jstate, tparams)
    assert int(tstate.step) == 4

    jclipped, jnorm = jadamw.clip_by_global_norm(jg, 1.0)
    tclipped, tnorm = tadamw.clip_by_global_norm({n: g.clone() for n, g in tgrads.items()},
                                                 1.0)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-5)
    assert float(tnorm) > 1.0
    for n, g in tclipped.items():
        np.testing.assert_allclose(_np(g), _np(_port_leaf(jclipped, n)), rtol=1e-6,
                                   atol=1e-7)

    cfg = tadamw.AdamWConfig(lr=0.05, weight_decay=0.5)
    jnew, jnew_state, jm = jadamw.adamw_update(jg, jstate, jp, opt, lr=0.02)
    _, tnew_state, tm = tadamw.adamw_update(tgrads, tstate, tparams, cfg, lr=0.02)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert int(tnew_state.step) == int(jnew_state.step) == 5
    ptol = dict(rtol=1e-6, atol=1e-7) if name == "fp32" else dict(rtol=2.0 ** -8, atol=0)
    for n, p in tparams.named_parameters():
        np.testing.assert_allclose(_np(p), _np(_port_leaf(jnew, n)), **ptol)
        for mine, theirs in ((tnew_state.m, jnew_state.m), (tnew_state.v, jnew_state.v)):
            np.testing.assert_allclose(_np(mine[n]), _np(_port_leaf(theirs, n)),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_opt_state_from_numpy_keeps_each_moment_dtype(name):
    """A JAX AdamW state comes across with its moments in their own dtype,
    bit for bit, whatever the port's AdamWConfig says."""
    jdt, tdt = DTYPES[name]
    _, _, _, jparams, _, tparams = _models("fp32")
    rng = np.random.default_rng(3)
    jstate = jadamw.adamw_init(jparams, jadamw.AdamWConfig(moment_dtype=jdt))
    jstate = jstate._replace(
        m=jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape), jdt), jstate.m),
        step=jnp.asarray(2, jnp.int32))
    tstate = tadamw.opt_state_from_numpy(jstate, tparams)
    assert int(tstate.step) == 2
    for n, _ in tparams.named_parameters():
        for mine, theirs in ((tstate.m, jstate.m), (tstate.v, jstate.v)):
            assert mine[n].dtype == tdt, n
            np.testing.assert_array_equal(_np(mine[n]),
                                          np.asarray(_port_leaf(theirs, n), np.float32))


def test_weight_decay_follows_the_jax_leaf_rank():
    """With zero gradients and moments only the decay moves a parameter:
    every per-layer tensor (a slice of a stacked JAX leaf, the 1-D norm
    scales included) decays, and the final norm's scale (1-D in JAX too)
    does not."""
    cfg = reduced(get_config("gemma2-2b"))
    params = DecoderModel(cfg, device="cpu").init(seed=0)
    with torch.no_grad():
        for p in params.parameters():
            p.fill_(1.0)
    opt = tadamw.AdamWConfig(lr=0.5, weight_decay=0.5, clip_norm=0.0)
    state = tadamw.adamw_init(params, opt)
    grads = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
    tadamw.adamw_update(grads, state, params, opt)
    for n, p in params.named_parameters():
        want = 1.0 if n == "ln_final.scale" else 0.75
        assert torch.all(p.float() == want), n
    assert {n for n, p in params.named_parameters()
            if tadamw.jax_rank(n, p) < 2} == {"ln_final.scale"}


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-7b", "whisper-medium",
                                  "qwen2-vl-7b"])
def test_adamw_decays_stacked_leaves_as_jax_does(arch):
    """One AdamW step, with weight decay and clipping, over a random fp32
    state of the reduced model's tree against repro.optim.adamw: the
    port decays exactly the leaves of rank >= 2 in JAX (jax_rank), which
    for these trees are stacked on one axis (enc_layers, dec_layers,
    slstm, layers) or two (mlstm, mamba), and not Zamba2's unstacked
    `shared` block's 1-D leaves."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), param_dtype=jnp.float32)
    tcfg = dataclasses.replace(reduced(get_config(arch)), param_dtype=torch.float32)
    shapes = jax.eval_shape(lambda: jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    params, grads, m = (_random_tree(rng, shapes) for _ in range(3))
    v = _random_tree(rng, shapes, positive=True)
    jstate = jadamw.AdamWState(m=jax.tree.map(jnp.asarray, m),
                               v=jax.tree.map(jnp.asarray, v), step=jnp.asarray(2, jnp.int32))
    jp, jg = (jax.tree.map(jnp.asarray, t) for t in (params, grads))
    tparams = params_from_numpy(params, tcfg, device="cpu")
    tgrads = {n: torch.tensor(np.asarray(_port_leaf(grads, n))) for n, _ in
              tparams.named_parameters()}
    tstate = tadamw.opt_state_from_numpy(jstate, tparams)
    for n, p in tparams.named_parameters():
        assert (tadamw.jax_rank(n, p) >= 2) == (np.ndim(_leaf_of(params, n)) >= 2), n
    jnew, jnew_state, jm = jadamw.adamw_update(jg, jstate, jp,
                                               jadamw.AdamWConfig(lr=0.05, weight_decay=0.5),
                                               lr=0.02)
    _, tnew_state, tm = tadamw.adamw_update(tgrads, tstate, tparams,
                                            tadamw.AdamWConfig(lr=0.05, weight_decay=0.5),
                                            lr=0.02)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    for n, p in tparams.named_parameters():
        np.testing.assert_allclose(_np(p), _np(_port_leaf(jnew, n)), rtol=1e-6, atol=5e-7,
                                   err_msg=n)
        np.testing.assert_allclose(_np(tnew_state.m[n]), _np(_port_leaf(jnew_state.m, n)),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def _leaf_of(tree, name):
    """The whole (stacked) JAX leaf that port parameter `name` slices."""
    return tt._leaf(tree, tt.param_leaf(tree, name)[0])


def test_adamw_updates_a_large_leaf_in_slices(monkeypatch):
    """Slicing a leaf's update (UPDATE_SLICE) changes no bit."""
    g = torch.Generator().manual_seed(0)
    p0 = torch.randn(3, 1000, generator=g)
    grads = {"layers.0.w": torch.randn(3, 1000, generator=g)}
    out = {}
    for size in (1 << 24, 333):
        monkeypatch.setattr(tadamw, "UPDATE_SLICE", size)
        params = {"layers.0.w": p0.clone()}
        state = tadamw.adamw_init(params, tadamw.AdamWConfig())
        tadamw.adamw_update({k: x.clone() for k, x in grads.items()}, state, params,
                            tadamw.AdamWConfig(), lr=0.01)
        out[size] = (params["layers.0.w"], state.m["layers.0.w"], state.v["layers.0.w"])
    for a, b in zip(*out.values()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the train step and the trainer
# ---------------------------------------------------------------------------
def test_three_train_steps_match_jax():
    """make_train_step against the JAX package's jitted one for 3 steps on
    TokenStream batches from the same state, in fp32, through the flash
    path: loss, grad_norm and lr each step, and the final parameters."""
    jcfg, tcfg, jmodel, jparams, _, tparams = _models("fp32")
    jopt = jadamw.AdamWConfig(lr=1e-3)
    topt = tadamw.AdamWConfig(lr=1e-3)
    jstate = jtrain.TrainState(params=jparams, opt=jadamw.adamw_init(jparams, jopt),
                               step=jnp.zeros((), jnp.int32))
    tstate = ttrain.TrainState(params=tparams,
                               opt=tadamw.opt_state_from_numpy(jstate.opt, tparams),
                               step=torch.zeros((), dtype=torch.int32))
    jstep = jax.jit(jtrain.make_train_step(jcfg, jopt, total_steps=20))
    tstep = ttrain.make_train_step(tcfg, topt, total_steps=20, device="cpu")
    data, jdata = TokenStream(tcfg, 2, 64, seed=1), JTokenStream(jcfg, 2, 64, seed=1)
    for i in range(3):
        jstate, jm = jstep(jstate, jdata(i))
        tstate, tm = tstep(tstate, data(i))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
    assert int(tstate.step) == 3 and int(tstate.opt.step) == 3
    for n, p in tparams.named_parameters():
        np.testing.assert_allclose(_np(p), _np(_port_leaf(jstate.params, n)), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_three_xlstm_train_steps_match_jax():
    """make_train_step of the reduced xlstm-350m against the JAX package's
    jitted one for 3 steps from the same state, in fp32, remat on in
    both (each mLSTM block recomputed): loss, grad_norm and lr each step,
    and the final parameters, the stacked gates and norms decayed as JAX
    decays them."""
    jdt, tdt = DTYPES["fp32"]
    jcfg = dataclasses.replace(jreduced(jget_config("xlstm-350m")), dtype=jdt,
                               param_dtype=jdt, remat=True)
    tcfg = dataclasses.replace(reduced(get_config("xlstm-350m")), dtype=tdt,
                               param_dtype=tdt, remat=True)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    opt = dict(lr=1e-3, eps=1e-3, weight_decay=0.5)
    jopt, topt = jadamw.AdamWConfig(**opt), tadamw.AdamWConfig(**opt)
    jstate = jtrain.TrainState(params=jparams, opt=jadamw.adamw_init(jparams, jopt),
                               step=jnp.zeros((), jnp.int32))
    tstate = ttrain.TrainState(params=tparams,
                               opt=tadamw.opt_state_from_numpy(jstate.opt, tparams),
                               step=torch.zeros((), dtype=torch.int32))
    jstep = jax.jit(jtrain.make_train_step(jcfg, jopt, total_steps=20))
    tstep = ttrain.make_train_step(tcfg, topt, total_steps=20, device="cpu")
    data, jdata = TokenStream(tcfg, 2, 70, seed=1), JTokenStream(jcfg, 2, 70, seed=1)
    for i in range(3):
        jstate, jm = jstep(jstate, jdata(i))
        tstate, tm = tstep(tstate, data(i))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
    assert int(tstate.step) == 3 and int(tstate.opt.step) == 3
    for n, p in tparams.named_parameters():
        np.testing.assert_allclose(_np(p), _np(_port_leaf(jstate.params, n)), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def _trainer_parts(cfg=None):
    cfg = cfg or reduced(get_config("gemma2-2b"))
    opt = tadamw.AdamWConfig(lr=1e-3)
    step = ttrain.make_train_step(cfg, opt, total_steps=100, device="cpu")
    return cfg, opt, step, TokenStream(cfg, batch=2, seq=32)


def test_trainer_recovers_from_injected_failures(tmp_path):
    """tests/test_checkpoint.py's recovery test in the port: failures at
    steps 7 and 12, each restoring the latest checkpoint bit for bit, and
    the loss falls over the run."""
    cfg, opt, step, data = _trainer_parts()
    state = ttrain.init_train_state(cfg, 0, opt, device="cpu")
    tr = Trainer(step, state, data, TrainerConfig(
        ckpt_dir=str(tmp_path), ckpt_every=5, use_async_ckpt=False, fail_at_steps=(7, 12)))
    restored = []
    real = tr._recover

    def recover():
        real()
        saved = tr.store.read_arrays(tr.step)
        live = state_arrays(tr.state)
        restored.append(tr.step)
        assert saved.keys() == {f"['{k}']" for k in live}
        for key, arr in live.items():
            assert arr.dtype == saved[f"['{key}']"].dtype
            np.testing.assert_array_equal(arr, saved[f"['{key}']"])

    tr._recover = recover
    out = tr.run(20, log_every=100)
    assert out["recoveries"] == 2 and restored == [5, 10]
    assert out["final_step"] == 20
    losses = out["loss_history"]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_trainer_resume_from_disk(tmp_path):
    cfg, opt, step, data = _trainer_parts()
    tcfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=5, use_async_ckpt=False)
    t1 = Trainer(step, ttrain.init_train_state(cfg, 0, opt, device="cpu"), data, tcfg)
    t1.run(10, log_every=100)
    # a new trainer resumes at step 10 from disk, with the state it saved
    t2 = Trainer(step, ttrain.init_train_state(cfg, 0, opt, device="cpu"), data, tcfg)
    assert t2.step == 10 and int(t2.state.step) == 10 and int(t2.state.opt.step) == 10
    for key, arr in state_arrays(t1.state).items():
        np.testing.assert_array_equal(state_arrays(t2.state)[key], arr)


def test_train_lm_example_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"), "--device", "cpu",
         "--steps", "3", "--batch", "2", "--seq", "32", "--inject-failure",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "final step 3, recoveries 2" in out.stdout
