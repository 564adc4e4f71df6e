"""The port's whisper encoder-decoder (`repro_torch/models/transformer.py`'s
`EncDec`, `models/api.py::EncDecModel`, the audio family of whisper-medium)
against the JAX package on the CPU.

The same numpy inputs, drawn under a seed, go through each JAX function and
its port: the reduced whisper-medium's loss_fn on both attention paths,
prefill_fn and decode_fn (caches included), `init_cross_cache`, the
gradients and `params_from_numpy`, with the JAX parameters carried across.
On the CPU the flash route is the kernel's plain version.

Whisper's cross-attention over a ragged number of frames: where the JAX
package takes its chunked path (S_q >= chunked_attn_min_len and S_k >
attn_chunk) it pads the keys with zeros that enter the softmax (ROADMAP.md,
queue 3, "In the reference"). The port's flash route masks them, so it is
held to the JAX direct path there, and to the chunked path only where S_k
is a multiple of the chunk; a test records that the two JAX paths differ.

Tolerances: fp32 rtol = atol = 1e-4 for the whole reduced model (the same
fp32 arithmetic, summed in other orders); bf16 3e-2, the JAX package's own
(tests/test_models.py:79), for logits and losses, while the bf16 caches of
raw activations (K, V) are held to the JAX package's own distance from its
fp32 forward (`_noise_close`, chip_smoke.py's noise-floor rule); fp32
gradients at rtol 1e-4 and an atol of 1e-5 of each parameter's largest
gradient magnitude (tests/test_torch_train.py's), and at least 1e-8: the
key biases' gradients are zero in exact arithmetic (a key bias adds the
same q . bk to every score of a row, which the softmax cancels), and both
packages give fp32 noise of about 1e-10 there; remat on and off equal bit
for bit.
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
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import EncDecModel, build_model, params_from_numpy  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
NOISE_FACTOR = 1.25    # chip_smoke.py's bf16 noise-floor factor
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
#: the JAX EncDecModel's decoder positions in these tests (its default is
#: 32,768; the port reads the tree's)
MAX_DEC = 256


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol=F32):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _cfgs(dtype="fp32", **upd):
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jreduced(jget_config("whisper-medium")), dtype=jdt,
                               param_dtype=jdt, **upd)
    tcfg = dataclasses.replace(reduced(get_config("whisper-medium")), dtype=tdt,
                               param_dtype=tdt, **upd)
    return jcfg, tcfg


def _jmodel(jcfg):
    from repro.models.api import EncDecModel as JEncDecModel

    return JEncDecModel(jcfg, max_dec_len=MAX_DEC)


def _models(dtype="fp32", seed=0, **upd):
    jcfg, tcfg = _cfgs(dtype, **upd)
    jmodel = _jmodel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jmodel, jparams, EncDecModel(tcfg, device="cpu",
                                                    max_dec_len=MAX_DEC), tparams


def _counting(monkeypatch, calls):
    real = ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)


def _noise_close(got, want, ref32, what):
    """A bf16 tensor of the port no farther from the fp32 forward's than the
    JAX package's bf16 tensor, within NOISE_FACTOR in mean and in root mean
    square."""
    ref32 = _np(ref32)
    eg, ej = np.abs(_np(got) - ref32), np.abs(_np(want) - ref32)
    assert eg.mean() <= NOISE_FACTOR * ej.mean(), (what, eg.mean(), ej.mean())
    rg, rj = np.sqrt((eg ** 2).mean()), np.sqrt((ej ** 2).mean())
    assert rg <= NOISE_FACTOR * rj, (what, rg, rj)


def _caches_close(got, want, tol, ref32=None):
    """The self and cross caches against the JAX package's; in bf16 (with
    `ref32`) the raw bf16 K/V by `_noise_close`."""
    for key in ("k", "v", "ck", "cv"):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        if ref32 is not None:
            _noise_close(got[key], want[key], ref32[key], key)
        else:
            _close(got[key], want[key], tol)
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))


def _fp32_reference(jcfg, jparams, prompt):
    """The JAX package's fp32 prefill of `prompt` with the bf16 weights cast
    to fp32, and a function taking its cache one decode step on."""
    model = _jmodel(dataclasses.replace(jcfg, dtype=jnp.float32, param_dtype=jnp.float32))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    decode = jax.jit(model.decode_fn)

    def step(out, tok):
        cache, logits = decode(params, out["cache"], tok)
        return {"cache": cache, "logits": logits}

    return jax.jit(model.prefill_fn)(params, prompt), step


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------
def test_token_stream_frames_are_the_jax_package_batches():
    cfg, jcfg = reduced(get_config("whisper-medium")), jreduced(jget_config("whisper-medium"))
    ours, theirs = TokenStream(cfg, 2, 16, seed=5)(3), JTokenStream(jcfg, 2, 16, seed=5)(3)
    assert ours.keys() == theirs.keys() == {"tokens", "labels", "frames"}
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])
    assert ours["frames"].shape == (2, cfg.encoder_seq, cfg.d_model)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_reduced_whisper_loss_prefill_decode_match_jax(dtype, monkeypatch):
    """loss_fn on both attention paths (S = 64 >= chunked_attn_min_len takes
    the flash wrapper for each decoder layer's causal self-attention; the
    24 frames are within one chunk of 32, so the cross-attention takes the
    direct path, as in JAX; a raised chunked_attn_min_len takes the direct
    path throughout), prefill of 32 tokens and 3 decode steps against the
    JAX package's jitted functions, self and cross caches included."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models(dtype)
    tol = F32 if dtype == "fp32" else BF16
    batch = TokenStream(tcfg, 2, 64, seed=3)(0)
    calls = []
    _counting(monkeypatch, calls)
    jloss, jmetrics = jax.jit(jmodel.loss_fn)(jparams, batch)
    for min_len, launches in ((64, [(64, 64, True)] * tcfg.n_layers), (1 << 30, [])):
        calls.clear()
        model = EncDecModel(dataclasses.replace(tcfg, chunked_attn_min_len=min_len),
                            device="cpu", max_dec_len=MAX_DEC)
        with torch.no_grad():
            loss, metrics = model.loss_fn(tparams, batch)
        assert calls == launches
        _close(loss, jloss, tol)
        assert float(metrics["tokens"]) == float(jmetrics["tokens"])
    calls.clear()
    prompt = {"tokens": batch["tokens"][:, :32], "frames": batch["frames"]}
    out = tmodel.prefill_fn(tparams, prompt)
    jout = jax.jit(jmodel.prefill_fn)(jparams, prompt)
    _close(out["logits"], jout["logits"], tol)
    ref, ref_decode = _fp32_reference(jcfg, jparams, prompt) if dtype == "bf16" else (None, None)
    _caches_close(out["cache"], jout["cache"], tol, ref and ref["cache"])
    cache, jcache = out["cache"], jout["cache"]
    jdecode = jax.jit(jmodel.decode_fn)
    for step in range(3):
        tok = {"tokens": batch["tokens"][:, 32 + step:33 + step]}
        cache, logits = tmodel.decode_fn(tparams, cache, tok)
        jcache, jlogits = jdecode(jparams, jcache, tok)
        _close(logits, jlogits, tol)
        if ref is not None:
            ref = ref_decode(ref, tok)
    _caches_close(cache, jcache, tol, ref and ref["cache"])
    assert not calls


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_whisper_cache_invariant(dtype):
    """prefill(t) against prefill(t[:-1]) + decode(t[-1]) on the port alone,
    the same frames: the self-attention cache and the decoder positions
    from the cache's index, the cross cache read as it is."""
    _, tcfg, _, _, tmodel, tparams = _models(dtype, seed=1)
    tol = F32 if dtype == "fp32" else BF16
    batch = TokenStream(tcfg, 2, 33, seed=4)(0)
    toks, frames = torch.as_tensor(batch["tokens"]), batch["frames"]
    full = tmodel.prefill_fn(tparams, {"tokens": toks, "frames": frames})
    short = tmodel.prefill_fn(tparams, {"tokens": toks[:, :-1], "frames": frames})
    cache, dec = tmodel.decode_fn(tparams, short["cache"], {"tokens": toks[:, -1:]})
    _close(dec, full["logits"], tol)
    np.testing.assert_array_equal(cache["pos"].numpy(), [33] * tcfg.n_layers)
    assert torch.equal(cache["ck"], full["cache"]["ck"])


def test_init_cross_cache_matches_jax():
    """Every decoder layer's cross-attention K and V of one encoder output,
    with non-zero K/V biases, stacked (L, B, S_enc, Hk, hd)."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(5)
    jparams = _jmodel(jcfg).init(jax.random.PRNGKey(2))
    tree = jax.tree.map(np.asarray, jparams)
    for key in ("bk", "bv"):
        tree["dec_layers"]["cross_attn"][key] = rng.normal(
            size=tree["dec_layers"]["cross_attn"][key].shape).astype(np.float32)
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    enc = rng.normal(size=(2, tcfg.encoder_seq, tcfg.d_model)).astype(np.float32)
    ck, cv = tt.init_cross_cache(tparams, tcfg, torch.tensor(enc))
    jck, jcv = jt.init_cross_cache(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(enc))
    assert tuple(ck.shape) == (tcfg.n_layers, 2, tcfg.encoder_seq, tcfg.n_kv_heads, tcfg.hd)
    _close(ck, jck, dict(rtol=1e-5, atol=1e-5))
    _close(cv, jcv, dict(rtol=1e-5, atol=1e-5))


def test_whisper_gradients_match_jax():
    """jax.grad(loss_fn) against the port's loss.backward() in fp32 on the
    flash path (S = 64), every parameter: the encoder's and decoder's
    position tables, layer norms' biases and the QKV biases included."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models(seed=1)
    batch = TokenStream(tcfg, 2, 64, seed=4)(0)
    loss, _ = tmodel.loss_fn(tparams, batch)
    loss.backward()
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for n, p in tparams.named_parameters():
        want = _np(tt.param_leaf(jgrads, n)[1])
        atol = max(1e-5 * float(np.abs(want).max()), 1e-8)
        np.testing.assert_allclose(_np(p.grad), want, rtol=1e-4, atol=atol, err_msg=n)


def test_whisper_remat_recomputes_each_layer(monkeypatch):
    """Under grad with cfg.remat each encoder layer and each cross-decoder
    layer runs under torch.utils.checkpoint, as the JAX package's
    jax.checkpoint(body): the gradients are those without remat bit for
    bit, and each layer's forward runs a second time in the backward."""
    _, tcfg, _, _, _, tparams = _models(seed=2)
    batch = TokenStream(tcfg, 2, 64, seed=5)(0)
    calls = {"encoder_layer": 0, "crossdec_layer": 0}
    for name in calls:
        real = getattr(tt, name)

        def counted(*a, _r=real, _n=name, **k):
            calls[_n] += 1
            return _r(*a, **k)
        monkeypatch.setattr(tt, name, counted)
    runs = {}
    for remat in (False, True):
        calls.update(encoder_layer=0, crossdec_layer=0)
        for p in tparams.parameters():
            p.grad = None
        model = EncDecModel(dataclasses.replace(tcfg, remat=remat), device="cpu",
                            max_dec_len=MAX_DEC)
        loss, _ = model.loss_fn(tparams, batch)
        loss.backward()
        runs[remat] = (float(loss.detach()), {n: p.grad.clone()
                                              for n, p in tparams.named_parameters()},
                       dict(calls))
    assert runs[True][0] == runs[False][0]
    for name, g in runs[False][1].items():
        assert torch.equal(g, runs[True][1][name]), name
    once = {"encoder_layer": tcfg.encoder_layers, "crossdec_layer": tcfg.n_layers}
    assert runs[False][2] == once
    assert runs[True][2] == {k: 2 * n for k, n in once.items()}


# ---------------------------------------------------------------------------
# the cross-attention over a ragged number of frames
# ---------------------------------------------------------------------------
def _cross_losses(encoder_seq):
    """The reduced model with `encoder_seq` frames at S = 64, chunk 32:
    (the port's loss, whose cross-attention takes the flash route, and the
    launches; the JAX loss on its chunked path; the JAX loss on its direct
    path, chunked_attn_min_len above S)."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models(seed=3, encoder_seq=encoder_seq)
    batch = TokenStream(tcfg, 2, 64, seed=6)(0)
    calls = []
    mp = pytest.MonkeyPatch()
    _counting(mp, calls)
    try:
        with torch.no_grad():
            loss, _ = tmodel.loss_fn(tparams, batch)
    finally:
        mp.undo()
    chunked = float(jax.jit(jmodel.loss_fn)(jparams, batch)[0])
    direct_model = _jmodel(dataclasses.replace(jcfg, chunked_attn_min_len=1 << 30))
    direct = float(jax.jit(direct_model.loss_fn)(jparams, batch)[0])
    return float(loss), calls, chunked, direct


def test_ragged_cross_attention_equals_the_jax_direct_path():
    """40 frames against a chunk of 32: the port's cross-attention takes the
    flash route (non-causal, S_q 64 over S_k 40, a ragged tail) in every
    decoder layer, and its loss is the JAX direct path's."""
    loss, calls, _, direct = _cross_losses(40)
    n = reduced(get_config("whisper-medium")).n_layers
    assert calls == [(64, 64, True), (64, 40, False)] * n
    np.testing.assert_allclose(loss, direct, **F32)


def test_jax_chunked_cross_attention_differs_at_a_ragged_encoder_seq():
    """A record of the reference's fault, not a property of the port: at 40
    frames and chunk 32 the JAX chunked path pads the keys to 64 with zeros
    that take part in the non-causal softmax, so its loss leaves its own
    direct path's, and the port's, by far more than their fp32 noise."""
    loss, _, chunked, direct = _cross_losses(40)
    assert abs(chunked - direct) > 1e-3 > abs(loss - direct)


def test_cross_attention_at_a_multiple_of_the_chunk_equals_the_jax_chunked_path():
    """64 frames, two whole chunks of 32: no padding, and the port's flash
    route equals the JAX chunked path (and its direct path)."""
    loss, calls, chunked, direct = _cross_losses(64)
    assert (64, 64, False) in calls
    np.testing.assert_allclose(loss, chunked, **F32)
    np.testing.assert_allclose(loss, direct, **F32)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def test_whisper_params_from_numpy_refuses_missing_and_extra_leaves():
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, _jmodel(jcfg).init(jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, tcfg, device="cpu")
    names = dict(params.named_parameters())
    assert {"enc_pos", "enc_layers.1.attn.bq", "enc_layers.0.ln_mlp.bias", "enc_ln_final.scale",
            "embed", "dec_pos", "dec_layers.1.cross_attn.wk", "dec_layers.0.ln_cross.bias",
            "dec_layers.1.mlp.w_gate", "dec_ln_final.bias"} <= set(names)
    assert tuple(names["dec_pos"].shape) == (MAX_DEC, tcfg.d_model)
    np.testing.assert_array_equal(_np(names["dec_layers.1.self_attn.wq"]),
                                  tree["dec_layers"]["self_attn"]["wq"][1])
    assert len(names) == sum(np.shape(leaf)[0] if path[0].key.endswith("_layers") else 1
                             for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0])
    with pytest.raises(ValueError, match="leaves with no parameter"):
        params_from_numpy(dict(tree, extra=np.zeros(3, np.float32)), tcfg, device="cpu")
    with pytest.raises(KeyError, match="enc_pos"):
        params_from_numpy({k: v for k, v in tree.items() if k != "enc_pos"}, tcfg,
                          device="cpu")
    grown = jax.tree.map(lambda a: np.concatenate([a, a[:1]]), tree["enc_layers"])
    with pytest.raises(ValueError, match="enc_layers/"):
        params_from_numpy(dict(tree, enc_layers=grown), tcfg, device="cpu")


def test_build_model_gives_the_encoder_decoder():
    model = build_model(reduced(get_config("whisper-medium")), device="cpu")
    assert isinstance(model, EncDecModel) and model.max_dec_len == 32_768
    params = model.init(seed=0)
    assert tuple(params.dec_pos.shape) == (32_768, model.cfg.d_model)
    assert all(type(m) is tt.LayerNorm for n, m in params.named_modules()
               if n.split(".")[-1].startswith("ln") or n.endswith("ln_final"))
