"""Whisper's training on the port against the JAX package on the CPU: the
flash backward at S_q != S_k (a cross-attention) and the reduced
whisper-medium's gradients and train steps with its cross-attention on the
flash route.

On the CPU `FlashAttention` runs its plain versions
(`ref.flash_attention_fwd_ref`, `ref.flash_attention_bwd_ref`); the CUDA
backward kernel at S_q != S_k is held against those on the card
(tests/test_torch_cuda.py, chip_smoke.py). Inputs and parameters come from
numpy under a seed and go through both packages.

Whisper's cross-attention over a ragged number of frames: the JAX chunked
path pads the keys with zeros that enter the softmax (ROADMAP.md, queue 3,
"In the reference"), so its gradients are not the function's. The port is
held to the JAX direct path (`chunked_attn_min_len` above S), as
tests/test_torch_encdec.py holds the forward, and a test records that the
JAX chunked gradients differ.

Tolerances, and why:
  * flash gradients against jax.grad of the direct oracle: fp32 rtol 1e-4
    and an atol of 1e-5 of each gradient's largest magnitude; bf16 one
    bf16 ulp of it (rtol and atol 2^-7 of it): tests/test_torch_train.py's,
    for the same reasons (fp32 sums in other orders; one rounding to bf16).
  * the reduced model's gradients in fp32: rtol 1e-4 and an atol of 1e-5 of
    each parameter's largest gradient magnitude, and at least 1e-8 (the key
    biases' gradients are fp32 noise about an exact zero):
    tests/test_torch_encdec.py's.
  * three train steps in fp32: loss, grad_norm and lr at rtol 1e-5, the
    parameters at rtol 1e-4 and atol 1e-6, tests/test_torch_train.py's.
    Adam's eps is 1e-3 in both packages, as in that file's xLSTM steps: the
    key biases' gradients are noise about zero there, and at eps 1e-8 Adam
    would make steps of up to lr out of it.
"""
import dataclasses

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
from repro.models.api import EncDecModel as JEncDecModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import EncDecModel, params_from_numpy  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
MAX_DEC = 256            # the JAX EncDecModel's decoder positions here
FRAMES = 40              # encoder frames: ragged against the chunk of 32
SEQ = 64                 # decoder tokens: reduced's chunked_attn_min_len


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_to_max(got, want, *, rtol, frac, floor=1e-30):
    got, want = _np(got), _np(want)
    atol = max(frac * float(np.abs(want).max()), floor)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the flash backward at S_q != S_k
# ---------------------------------------------------------------------------
CROSS_CASES = [
    # bh, bhk, sq, sk, d, causal, window, cap, dtype
    (4, 4, 70, 40, 32, False, 0, 0.0, "fp32"),    # whisper's: non-causal, ragged S_k
    (8, 4, 70, 40, 32, False, 0, 0.0, "fp32"),    # a group of 2
    (4, 2, 33, 65, 64, False, 0, 30.0, "fp32"),   # S_k > S_q, softcap
    (4, 2, 48, 40, 32, True, 0, 0.0, "fp32"),     # causal, S_k < S_q
    (4, 2, 40, 72, 32, True, 16, 50.0, "fp32"),   # causal window, S_k > S_q
    (4, 4, 70, 40, 64, False, 0, 0.0, "bf16"),
    (8, 4, 33, 65, 32, True, 8, 50.0, "bf16"),
]


@pytest.mark.parametrize("bh,bhk,sq,sk,d,causal,window,cap,name", CROSS_CASES)
def test_flash_gradients_at_sq_ne_sk_match_jax(bh, bhk, sq, sk, d, causal, window, cap,
                                               name):
    """FlashAttention with grad at S_q != S_k (the plain versions on the
    CPU, launching nothing) against jax.grad of the JAX direct oracle, the
    KV heads repeated for its GQA."""
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(bh + sq + 3 * sk + d)
    q = rng.normal(size=(bh, sq, d)).astype(np.float32)
    k, v = (rng.normal(size=(bhk, sk, d)).astype(np.float32) for _ in range(2))
    do = rng.normal(size=(bh, sq, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=cap)
    tq, tk, tv = (torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v))
    ops.reset_launches()
    out = ops.flash_attention(tq, tk, tv, **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(do).to(tdt))
    assert sum(ops.launches().values()) == 0
    rep = bh // bhk
    jdo = jnp.asarray(do, jdt).astype(jnp.float32)

    def oracle(q, k, v):
        o = jref.flash_attention_ref(q, jnp.repeat(k, rep, axis=0), jnp.repeat(v, rep, axis=0),
                                     **kw)
        return jnp.sum(o.astype(jnp.float32) * jdo)

    want = jax.jit(jax.grad(oracle, argnums=(0, 1, 2)))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    tol = (dict(rtol=1e-4, frac=1e-5) if name == "fp32"
           else dict(rtol=2.0 ** -7, frac=2.0 ** -7))
    for g, w, what in zip(got, want, "qkv"):
        assert g.shape == w.shape and g.dtype == tdt, what
        _close_to_max(g, w, **tol)


def test_flash_bwd_ref_gradcheck_at_sq_ne_sk():
    """The plain backward in float64 against finite differences of the
    plain forward, non-causal, S_q 9 over a group of 2 on S_k 6."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(4, 9, 8, generator=g, dtype=torch.float64, requires_grad=True)
    k, v = (torch.randn(2, 6, 8, generator=g, dtype=torch.float64, requires_grad=True)
            for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, causal=False, softcap=3.0), (q, k, v))


def test_flash_bwd_wrapper_checks_shapes_against_sq_and_sk():
    """On the CPU the wrapper takes the plain version at S_q != S_k; the
    lse it is given is (BH, S_q)."""
    q = torch.randn(2, 5, 32)  # repro-lint: disable=rng-global (only shapes are checked)
    k, v = torch.randn(1, 3, 32), torch.randn(1, 3, 32)  # repro-lint: disable=rng-global (shapes only)
    out, lse, o = ops.flash_forward(q, k, v, False, 0, 0.0, 32 ** -0.5)
    assert lse.shape == (2, 5) and o.numel() == 0    # fp32: out is unrounded
    dq, dk, dv = ops.flash_attention_bwd(q, k, v, torch.ones_like(q), lse, out,
                                         causal=False, window=0, softcap=0.0,
                                         scale=32 ** -0.5)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape


# ---------------------------------------------------------------------------
# the reduced whisper-medium
# ---------------------------------------------------------------------------
def _models(seed, **upd):
    jdt, tdt = DTYPES["fp32"]
    jcfg = dataclasses.replace(jreduced(jget_config("whisper-medium")), dtype=jdt,
                               param_dtype=jdt, encoder_seq=FRAMES, **upd)
    tcfg = dataclasses.replace(reduced(get_config("whisper-medium")), dtype=tdt,
                               param_dtype=tdt, encoder_seq=FRAMES, **upd)
    jparams = JEncDecModel(jcfg, max_dec_len=MAX_DEC).init(jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _jgrads(jcfg, jparams, batch, min_len):
    model = JEncDecModel(dataclasses.replace(jcfg, chunked_attn_min_len=min_len),
                         max_dec_len=MAX_DEC)
    (loss, _), grads = jax.jit(jax.value_and_grad(model.loss_fn, has_aux=True))(
        jparams, batch)
    return float(loss), grads


@pytest.fixture(scope="module")
def whisper_grads():
    """The reduced whisper with 40 frames at S = 64: the port's loss and
    gradients (its flash launches recorded), and jax.grad of the JAX
    package's direct and chunked paths, from the same parameters and
    batch."""
    jcfg, tcfg, jparams, tparams = _models(seed=7)
    batch = TokenStream(tcfg, 2, SEQ, seed=8)(0)
    calls = []
    real = ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"], torch.is_grad_enabled()))
        return real(q, k, v, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "flash_attention", counted)
        loss, _ = EncDecModel(tcfg, device="cpu", max_dec_len=MAX_DEC).loss_fn(tparams, batch)
        loss.backward()
    return dict(tcfg=tcfg, tparams=tparams, loss=float(loss.detach()), calls=calls,
                direct=_jgrads(jcfg, jparams, batch, 1 << 30),
                chunked=_jgrads(jcfg, jparams, batch, jcfg.chunked_attn_min_len))


def test_whisper_flash_gradients_match_the_jax_direct_path(whisper_grads):
    """The reduced whisper with 40 frames at S = 64: every decoder layer's
    self-attention (64 x 64, causal) and cross-attention (64 x 40,
    non-causal, ragged) take the flash route with grad, and loss.backward()
    gives jax.grad of the JAX direct path, every parameter."""
    g = whisper_grads
    assert g["calls"] == [(SEQ, SEQ, True, True), (SEQ, FRAMES, False, True)] \
        * g["tcfg"].n_layers
    jloss, jgrads = g["direct"]
    np.testing.assert_allclose(g["loss"], jloss, rtol=1e-5)
    for n, p in g["tparams"].named_parameters():
        _close_to_max(p.grad, tt.param_leaf(jgrads, n)[1], rtol=1e-4, frac=1e-5, floor=1e-8)


def test_jax_chunked_whisper_gradients_differ_at_a_ragged_encoder_seq(whisper_grads):
    """A record of the reference's fault, not a property of the port: the
    JAX chunked path's zero-padded keys move its gradients far from its own
    direct path's, which the port's equal (the test above)."""
    g = whisper_grads
    name = "dec_layers.0.cross_attn.wq"
    want, far = (_np(tt.param_leaf(x[1], name)[1]) for x in (g["direct"], g["chunked"]))
    scale = float(np.abs(want).max())
    assert float(np.abs(far - want).max()) > 1e-2 * scale
    got = _np(dict(g["tparams"].named_parameters())[name].grad)
    assert float(np.abs(got - want).max()) < 1e-5 * scale


def test_three_whisper_train_steps_match_jax():
    """make_train_step of the reduced whisper (remat on: each encoder and
    cross-decoder layer recomputed; the cross-attention on the flash route)
    against the JAX package's jitted step on its direct path, 3 steps from
    the same state in fp32: loss, grad_norm and lr each step, and the final
    parameters."""
    jcfg, tcfg, jparams, tparams = _models(seed=9, remat=True)
    jcfg = dataclasses.replace(jcfg, chunked_attn_min_len=1 << 30)
    opt = dict(lr=1e-3, eps=1e-3)
    jopt, topt = jadamw.AdamWConfig(**opt), tadamw.AdamWConfig(**opt)
    jstate = jtrain.TrainState(params=jparams, opt=jadamw.adamw_init(jparams, jopt),
                               step=jnp.zeros((), jnp.int32))
    tstate = ttrain.TrainState(params=tparams,
                               opt=tadamw.opt_state_from_numpy(jstate.opt, tparams),
                               step=torch.zeros((), dtype=torch.int32))
    jstep = jax.jit(jtrain.make_train_step(jcfg, jopt, total_steps=20))
    tstep = ttrain.make_train_step(tcfg, topt, total_steps=20, device="cpu")
    data, jdata = TokenStream(tcfg, 2, SEQ, seed=1), JTokenStream(jcfg, 2, SEQ, seed=1)
    for i in range(3):
        jstate, jm = jstep(jstate, jdata(i))
        tstate, tm = tstep(tstate, data(i))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
    assert int(tstate.step) == 3
    for n, p in tparams.named_parameters():
        np.testing.assert_allclose(_np(p), _np(tt.param_leaf(jstate.params, n)[1]),
                                   rtol=1e-4, atol=1e-6, err_msg=n)
