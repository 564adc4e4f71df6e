"""The port's dense decoder LM (gemma2-2b) against the JAX package on the CPU.

Inputs and parameters come from numpy under a seed (the JAX parameters are
carried across with `params_from_numpy`) and go through both packages.
The JAX flash kernel runs as its own tests run it: `ops.flash_attention`
picks interpret mode on the CPU. The port's wrapper runs its plain version
for CPU tensors; the CUDA kernel is held against that plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances, and why:
  * flash attention: 3e-4 in fp32 and 3e-2 in bf16, the JAX kernel tests'
    own (tests/test_kernels.py:88, 91); the chunked attention at 5e-4, the
    JAX package's own kernel-vs-chunked bound (tests/test_kernels.py:119).
  * layers in fp32: 1e-5; the same fp32 arithmetic, summed in another
    order.
  * the whole reduced model in fp32: rtol/atol 1e-4 on loss, logits and
    caches (measured differences are below 3e-6).
  * the whole reduced model in bf16: 3e-2, the JAX package's bf16
    tolerance (tests/test_models.py:78): the two frameworks round bf16
    intermediates at different places.
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
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.api import LM_SHAPES as JLM_SHAPES  # noqa: E402
from repro.models import layers as jl, transformer as jt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import LM_SHAPES, DecoderModel, params_from_numpy  # noqa: E402
from repro_torch.models import layers as tl, transformer as tt  # noqa: E402

F32 = dict(rtol=3e-4, atol=3e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# flash attention: the plain version against the JAX kernel and its oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bh,bhk,s,d,window,cap", [
    (4, 4, 128, 32, 0, 0.0),
    (2, 2, 256, 64, 64, 0.0),
    (3, 3, 128, 32, 0, 30.0),
    (1, 1, 384, 64, 128, 50.0),
    (2, 2, 200, 32, 0, 0.0),          # ragged S
    (2, 2, 64, 256, 16, 50.0),        # gemma2's head width
    (4, 2, 96, 64, 32, 50.0),         # GQA: two query heads a KV head
])
def test_flash_plain_matches_jax_kernel_and_oracle(bh, bhk, s, d, window, cap):
    rng = np.random.default_rng(s + d + bhk)
    q = _normal(rng, (bh, s, d))
    k = _normal(rng, (bhk, s, d))
    v = _normal(rng, (bhk, s, d))
    got = ops.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                              causal=True, window=window, softcap=cap)
    rep = bh // bhk
    ke, ve = (jnp.repeat(jnp.asarray(x), rep, axis=0) for x in (k, v))
    kw = dict(causal=True, window=window, softcap=cap)
    _close(got, jops.flash_attention(jnp.asarray(q), ke, ve, **kw), F32)
    _close(got, jref.flash_attention_ref(jnp.asarray(q), ke, ve, **kw), F32)


@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_flash_plain_dtypes(name):
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(9)
    q, k, v = (_normal(rng, (2, 128, 64)) for _ in range(3))
    got = ops.flash_attention(*(torch.tensor(x).to(tdt) for x in (q, k, v)), causal=True)
    assert got.dtype == tdt
    want = jops.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), causal=True)
    _close(got, want, F32 if name == "fp32" else BF16)


def test_flash_raises_where_the_jax_wrapper_raises():
    rng = np.random.default_rng(1)
    for s, raises in ((200, True), (10, True), (256, False), (48, False)):
        q, k, v = (_normal(rng, (2, s, 32)) for _ in range(3))
        if raises:
            with pytest.raises(ValueError):
                jops.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=False)
            with pytest.raises(ValueError):
                ops.flash_attention(*(torch.tensor(x) for x in (q, k, v)), causal=False)
        else:
            got = ops.flash_attention(*(torch.tensor(x) for x in (q, k, v)), causal=False)
            want = jops.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=False)
            _close(got, want, F32)


# ---------------------------------------------------------------------------
# attention in the model's layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window,cap", [(0, 0.0), (48, 50.0)])
def test_chunked_attention_matches_jax_chunk_path(window, cap):
    """The port's chunked branch (the flash kernel's plain version on the
    CPU) against the JAX package's jnp chunked scan, with GQA."""
    rng = np.random.default_rng(3)
    b, s, h, hk, hd = 2, 256, 4, 2, 32
    q = _normal(rng, (b, s, h, hd))
    k, v = (_normal(rng, (b, s, hk, hd)) for _ in range(2))
    kw = dict(causal=True, window=window, attn_softcap=cap, chunk=64)
    calls = []
    real = ops.flash_attention

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "flash_attention", spy)
    try:
        got = tl.multi_head_attention(*(torch.tensor(x) for x in (q, k, v)), **kw)
    finally:
        mp.undo()
    assert calls == [1]
    want = jl.multi_head_attention(*(jnp.asarray(x) for x in (q, k, v)), **kw)
    _close(got, want, dict(rtol=5e-4, atol=5e-4))


def test_chunked_branch_raises_on_what_the_model_never_gives_it():
    q = torch.zeros(1, 64, 2, 32)
    with pytest.raises(ValueError):
        tl.multi_head_attention(q, q[:, :48], q[:, :48], causal=True, chunk=16)
    with pytest.raises(ValueError):
        tl.multi_head_attention(q, q, q, causal=True, chunk=16, q_offset=3)


@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_direct_attention_with_offset_matches_jax(name):
    """The decode-cache path: a few queries at an offset over a longer
    buffer, softcap and window, GQA."""
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(4)
    q = _normal(rng, (2, 3, 4, 32))
    k, v = (_normal(rng, (2, 40, 2, 32)) for _ in range(2))
    kw = dict(causal=True, window=16, attn_softcap=50.0)
    got = tl.multi_head_attention(*(torch.tensor(x).to(tdt) for x in (q, k, v)),
                                  q_offset=torch.tensor(20, dtype=torch.int32), **kw)
    want = jl.multi_head_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                   q_offset=jnp.int32(20), **kw)
    _close(got, want, F32 if name == "fp32" else BF16)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rms_norm_softcap_and_rope_match_jax():
    rng = np.random.default_rng(5)
    x = _normal(rng, (2, 6, 4, 32))
    scale = 0.1 * _normal(rng, (32,))
    tol = dict(rtol=1e-5, atol=1e-5)
    _close(tl.rms_norm(torch.tensor(x), torch.tensor(scale), 1e-6),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6), tol)
    _close(tl.softcap(torch.tensor(60 * x), 50.0), jl.softcap(jnp.asarray(60 * x), 50.0), tol)
    pos = np.broadcast_to(np.arange(100, 106, dtype=np.int32), (2, 6))
    _close(tl.apply_rope(torch.tensor(x), torch.tensor(pos), 10_000.0),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), tol)


def test_mlp_block_uses_tanh_gelu_as_jax():
    jcfg = dataclasses.replace(jreduced(jget_config("gemma2-2b")), dtype=jnp.float32,
                               param_dtype=jnp.float32)
    tcfg = dataclasses.replace(reduced(get_config("gemma2-2b")), dtype=torch.float32,
                               param_dtype=torch.float32)
    jp = jax.tree.map(np.asarray, jl.init_mlp(jax.random.PRNGKey(1), jcfg))
    mlp = tl.init_mlp(tcfg, generator=None, device=torch.device("cpu"))
    with torch.no_grad():
        for name, p in mlp.named_parameters():
            p.copy_(torch.tensor(jp[name]))
    x = 3.0 * _normal(np.random.default_rng(6), (2, 5, tcfg.d_model))
    with torch.no_grad():
        got = tl.mlp_block(mlp, torch.tensor(x), tcfg)
    _close(got, jl.mlp_block(jp, jnp.asarray(x), jcfg), dict(rtol=1e-5, atol=1e-5))
    # the exact-erf GELU is measurably different at these inputs
    erf = torch.nn.functional.gelu(torch.tensor(x) @ mlp.w_gate) * (torch.tensor(x) @ mlp.w_up)
    assert not torch.allclose((erf @ mlp.w_down).detach(), got, rtol=1e-5, atol=1e-5)


def test_layer_windows_put_the_window_on_even_layers():
    cfg = get_config("gemma2-2b")
    w = tt.layer_windows(cfg).numpy()
    np.testing.assert_array_equal(w, np.asarray(jt.layer_windows(jget_config("gemma2-2b"))))
    assert w.shape == (26,) and (w[::2] == 4096).all() and (w[1::2] == 0).all()


def test_configs_match_jax():
    for port, jax_cfg in ((get_config("gemma2-2b"), jget_config("gemma2-2b")),
                          (reduced(get_config("gemma2-2b")), jreduced(jget_config("gemma2-2b")))):
        for f in dataclasses.fields(port):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(port, f.name) == getattr(jax_cfg, f.name), f.name
        assert port.hd == jax_cfg.hd
        assert (port.remat, port.remat_policy) == (jax_cfg.remat, jax_cfg.remat_policy)
    assert get_config("gemma2-2b").remat and get_config("gemma2-2b").remat_policy == "nothing"
    assert not reduced(get_config("gemma2-2b")).remat
    for name in ("smollm-360m", "no-such-model"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            get_config(name)
    moe = dataclasses.replace(get_config("gemma2-2b"), family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        DecoderModel(moe, device="cpu")


def test_lm_shapes_match_jax():
    assert [dataclasses.astuple(s) for s in LM_SHAPES] == [
        (s.name, s.seq_len, s.global_batch, s.kind) for s in JLM_SHAPES]


def test_token_stream_batches_are_bit_equal():
    for cfg, jcfg in ((get_config("gemma2-2b"), jget_config("gemma2-2b")),
                      (reduced(get_config("gemma2-2b")), jreduced(jget_config("gemma2-2b")))):
        ours, theirs = TokenStream(cfg, 3, 40, seed=7), JTokenStream(jcfg, 3, 40, seed=7)
        for step in (0, 5):
            a, b = ours(step), theirs(step)
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


# ---------------------------------------------------------------------------
# the whole reduced model
# ---------------------------------------------------------------------------
def _models(name):
    jdt, tdt = DTYPES[name]
    jcfg = dataclasses.replace(jreduced(jget_config("gemma2-2b")), dtype=jdt, param_dtype=jdt)
    tcfg = dataclasses.replace(reduced(get_config("gemma2-2b")), dtype=tdt, param_dtype=tdt)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jmodel, jparams, DecoderModel(tcfg, device="cpu"), tparams


@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_reduced_gemma2_loss_prefill_decode_match_jax(name, monkeypatch):
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models(name)
    tol = dict(rtol=1e-4, atol=1e-4) if name == "fp32" else BF16
    batch = TokenStream(tcfg, 2, 64, seed=3)(0)

    # loss_fn at (2, 64) takes the chunked path: reduced sets
    # chunked_attn_min_len = 64, so every layer runs the flash wrapper
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        loss, metrics = tmodel.loss_fn(tparams, batch)
    assert len(calls) == tcfg.n_layers
    jloss, jmetrics = jax.jit(jmodel.loss_fn)(jparams, batch)
    _close(loss, jloss, tol)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"])

    prompt = {"tokens": batch["tokens"][:, :32]}
    out = tmodel.prefill_fn(tparams, prompt)
    jout = jax.jit(jmodel.prefill_fn)(jparams, prompt)
    assert len(calls) == tcfg.n_layers      # prefill runs the direct path
    _close(out["logits"], jout["logits"], tol)
    for key in ("k", "v"):
        assert out["cache"][key].shape == jout["cache"][key].shape
        _close(out["cache"][key], jout["cache"][key], tol)
    np.testing.assert_array_equal(out["cache"]["pos"].numpy(), np.asarray(jout["cache"]["pos"]))

    cache, jcache = out["cache"], jout["cache"]
    jdecode = jax.jit(jmodel.decode_fn)
    for step in range(3):
        tok = {"tokens": batch["tokens"][:, 32 + step:33 + step]}
        cache, logits = tmodel.decode_fn(tparams, cache, tok)
        jcache, jlogits = jdecode(jparams, jcache, tok)
        _close(logits, jlogits, tol)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))


def test_reduced_gemma2_scores_past_the_softcap_match_jax(monkeypatch):
    """Every wq x 16 drives the attention scores past the softcap of 50 (at
    x 1 the largest is about 4): the port's forward logits still match the
    JAX package's at the fp32 tolerance of the parity test above, and the
    same forward with the softcap dropped in the flash wrapper does not."""
    scale = 16.0
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models("fp32")
    jparams = dict(jparams, layers=dict(jparams["layers"], attn=dict(
        jparams["layers"]["attn"], wq=jparams["layers"]["attn"]["wq"] * scale)))
    with torch.no_grad():
        for layer in tparams.layers:
            layer.attn.wq.mul_(scale)
    tokens = TokenStream(tcfg, 2, 64, seed=3)(0)["tokens"]
    positions = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64))
    jlogits = jt.decoder_forward(jparams, jcfg, jnp.asarray(tokens),
                                 positions=jnp.asarray(positions))[0]

    real, peak = ops.flash_attention, []

    def seen(q, k, v, **kw):      # the scores the flash wrapper is given
        s = torch.einsum("bqd,bkd->bqk", q.float(),
                         k.float().repeat_interleave(q.shape[0] // k.shape[0], 0))
        peak.append(float(s.abs().max()) * kw["scale"])
        return real(q, k, v, **kw)

    def forward():
        with torch.no_grad():
            return tt.decoder_forward(tparams, tcfg, torch.as_tensor(tokens),
                                      positions=torch.as_tensor(positions.copy()))[0]

    monkeypatch.setattr(ops, "flash_attention", seen)
    logits = forward()
    assert len(peak) == tcfg.n_layers and max(peak) > tcfg.attn_softcap
    _close(logits, jlogits, dict(rtol=1e-4, atol=1e-4))

    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, **kw: real(q, k, v, **dict(kw, softcap=0.0)))
    dropped = forward()
    assert not np.allclose(_np(dropped), _np(jlogits), rtol=1e-4, atol=1e-4)


def test_prefill_then_decode_matches_full_prefill():
    """tests/test_models.py's cache invariant, in the port: prefill(t[:-1])
    + decode(t[-1]) gives the logits of prefill(t)."""
    cfg = reduced(get_config("gemma2-2b"))
    model = DecoderModel(cfg, device="cpu")
    params = model.init(seed=0)
    toks = torch.randint(0, 128, (2, 32), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    full = model.prefill_fn(params, {"tokens": toks})["logits"]
    short = model.prefill_fn(params, {"tokens": toks[:, :-1]})
    _, dec = model.decode_fn(params, short["cache"], {"tokens": toks[:, -1:]})
    _close(full, dec, BF16)


def test_init_and_params_from_numpy_follow_the_jax_tree():
    jcfg = jreduced(jget_config("gemma2-2b"))
    shapes = jax.eval_shape(lambda: jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    tcfg = reduced(get_config("gemma2-2b"))
    params = DecoderModel(tcfg, device="cpu").init(seed=0)
    again = DecoderModel(tcfg, device="cpu").init(seed=0)
    for name, p in params.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            sd = shapes["layers"]
            for key in parts[2:]:
                sd = sd[key]
            want = sd.shape[1:]
        else:
            sd = shapes
            for key in parts:
                sd = sd[key]
            want = sd.shape
        assert tuple(p.shape) == tuple(want), name
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, dict(again.named_parameters())[name]), name
    # dense_init: std 1/sqrt(fan_in), truncated at +-2 std
    w = params.layers[0].mlp.w_up.detach().float()
    std = 1.0 / np.sqrt(tcfg.d_model)
    assert float(w.abs().max()) <= 2 * std * 1.01
    assert abs(float(w.std()) / std - 0.88) < 0.05     # a +-2 truncated normal's std
    assert abs(float(params.embed.detach().float().std()) / 0.02 - 0.88) < 0.05
    assert float(params.ln_final.scale.detach().abs().max()) == 0.0


def test_params_from_numpy_refuses_a_tree_that_does_not_fit():
    jcfg = jreduced(jget_config("gemma2-2b"))
    tree = jax.tree.map(np.asarray, jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    tcfg = reduced(get_config("gemma2-2b"))
    with pytest.raises(ValueError, match="leaves with no parameter"):
        params_from_numpy(dict(tree, unembed=np.zeros((128, 512), np.float32)), tcfg,
                          device="cpu")
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(dict(tree, embed=np.zeros((500, 128), np.float32)), tcfg,
                          device="cpu")
