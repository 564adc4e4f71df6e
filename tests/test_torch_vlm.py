"""The port's VLM decoder (qwen2-vl-7b: `models/layers.py::apply_mrope`, the
patch-embedding branch of `models/api.py::DecoderModel`) against the JAX
package on the CPU.

The same numpy inputs, drawn under a seed, go through each JAX function and
its port: M-RoPE on positions whose three (t, h, w) channels differ, and the
reduced qwen2-vl-7b's loss_fn on both attention paths, prefill_fn and
decode_fn (caches included) and gradients, with the JAX parameters carried
across by `params_from_numpy`. Positions follow Qwen2-VL's own rule where
the channels matter: the patches at t = 0 on an (h, w) grid, the text from
the grid's side on all three channels, each decode step's given by the
batch. On the CPU the flash route is the kernel's plain version.

Tolerances: M-RoPE in fp32 at rtol = atol = 1e-6 (the same fp32 products
of the same angles; JAX's einsum of the lane positions and frequencies is
one product an entry), in bf16 within one bf16 rounding (2^-8 relative);
the whole reduced model in fp32 at rtol = atol = 1e-4; in bf16 the loss
at 3e-2 (the JAX package's own, tests/test_models.py:79), and the prefill
and decode logits and the K/V caches held to the JAX package's own
distance from its fp32 forward (`_noise_close`, chip_smoke.py's
noise-floor rule): 1 of the 1,024 bf16 logits of one step lay 0.031 from
JAX's, past 3e-2; fp32 gradients at rtol 1e-4 and an atol of 1e-5 of each
parameter's largest gradient magnitude, and at least 1e-8 (the key
biases' gradients are zero in exact arithmetic: fp32 noise on both
sides).
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
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import DecoderModel, build_model, params_from_numpy  # noqa: E402
from repro_torch.models import layers as tl, transformer as tt  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
NOISE_FACTOR = 1.25    # chip_smoke.py's bf16 noise-floor factor
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol=F32):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _cfgs(dtype="fp32", **upd):
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jreduced(jget_config("qwen2-vl-7b")), dtype=jdt,
                               param_dtype=jdt, **upd)
    tcfg = dataclasses.replace(reduced(get_config("qwen2-vl-7b")), dtype=tdt,
                               param_dtype=tdt, **upd)
    return jcfg, tcfg


def _models(dtype="fp32", seed=0, **upd):
    jcfg, tcfg = _cfgs(dtype, **upd)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jmodel, jparams, DecoderModel(tcfg, device="cpu"), tparams


def grid_positions(n_patches: int, n_text: int, batch: int) -> np.ndarray:
    """Qwen2-VL's M-RoPE positions (B, 3, n_patches + n_text): the patches
    at t = 0 on a square (h, w) grid, then the text from the grid's side
    on all three channels."""
    side = int(round(n_patches ** 0.5))
    idx = np.arange(n_patches)
    patches = np.stack([np.zeros(n_patches), idx // side, idx % side])
    text = np.broadcast_to(side + np.arange(n_text), (3, n_text))
    return np.broadcast_to(np.concatenate([patches, text], axis=1).astype(np.int32),
                           (batch, 3, n_patches + n_text)).copy()


def _batch(tcfg, b, n_text, seed):
    """A TokenStream batch with Qwen2-VL's grid positions in place of the
    stream's 0 .. S - 1 on every channel."""
    batch = TokenStream(tcfg, b, n_text, seed=seed)(0)
    batch["positions"] = grid_positions(tcfg.n_patches, n_text, b)
    return batch


def _prefix(batch, n_text):
    """The batch's patches and first n_text tokens (prefill inputs)."""
    npch = batch["patch_embeds"].shape[1]
    return {"tokens": batch["tokens"][:, :n_text], "patch_embeds": batch["patch_embeds"],
            "positions": batch["positions"][:, :, :npch + n_text]}


def _noise_close(got, want, ref32, what):
    """A bf16 tensor of the port no farther from the fp32 forward's than the
    JAX package's bf16 tensor, within NOISE_FACTOR in mean and in root mean
    square."""
    ref32 = _np(ref32)
    eg, ej = np.abs(_np(got) - ref32), np.abs(_np(want) - ref32)
    assert eg.mean() <= NOISE_FACTOR * ej.mean(), (what, eg.mean(), ej.mean())
    rg, rj = np.sqrt((eg ** 2).mean()), np.sqrt((ej ** 2).mean())
    assert rg <= NOISE_FACTOR * rj, (what, rg, rj)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_apply_mrope_matches_jax_on_channels_that_differ(dtype):
    """Each section of the hd / 2 lanes rotates by its own channel: random
    positions, independent on t, h and w, at the reduced (4, 6, 6) and the
    published (16, 24, 24) sections."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "fp32" else dict(rtol=2.0 ** -8, atol=1e-6)
    for hd, sections, theta in ((32, (4, 6, 6), 1e6), (128, (16, 24, 24), 1e6)):
        x = rng.normal(size=(2, 7, 3, hd)).astype(np.float32)
        pos = rng.integers(0, 5000, size=(2, 3, 7)).astype(np.int32)
        assert (pos[:, 0] != pos[:, 1]).any() and (pos[:, 1] != pos[:, 2]).any()
        got = tl.apply_mrope(torch.tensor(x).to(tdt), torch.tensor(pos), theta, sections)
        want = jl.apply_mrope(jnp.asarray(x, jdt), jnp.asarray(pos), theta, sections)
        assert got.dtype == tdt
        _close(got, want, tol)
        # a channel moved moves the output: each section reads its own channel
        for c in range(3):
            moved = pos.copy()
            moved[:, c] += 1
            other = tl.apply_mrope(torch.tensor(x), torch.tensor(moved), theta, sections)
            lanes = np.arange(sum(sections[:c]), sum(sections[:c + 1]))
            still = np.setdiff1d(np.arange(hd // 2), lanes)
            base = tl.apply_mrope(torch.tensor(x), torch.tensor(pos), theta, sections)
            for half in (0, hd // 2):
                assert not torch.equal(other[..., half + lanes], base[..., half + lanes])
                assert torch.equal(other[..., half + still], base[..., half + still])


def test_apply_mrope_is_rope_where_the_channels_agree():
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(2, 5, 3, 32)).astype(np.float32))
    pos = torch.tensor(rng.integers(0, 100, size=(2, 5)).astype(np.int32))
    got = tl.apply_mrope(x, pos[:, None, :].expand(2, 3, 5), 1e4, (4, 6, 6))
    assert torch.equal(got, tl.apply_rope(x, pos, 1e4))
    with pytest.raises(ValueError, match="sum"):
        tl.apply_mrope(x, pos[:, None, :].expand(2, 3, 5), 1e4, (4, 6, 5))


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------
def test_token_stream_patches_are_the_jax_package_batches():
    cfg, jcfg = reduced(get_config("qwen2-vl-7b")), jreduced(jget_config("qwen2-vl-7b"))
    ours, theirs = TokenStream(cfg, 2, 16, seed=5)(3), JTokenStream(jcfg, 2, 16, seed=5)(3)
    assert ours.keys() == theirs.keys() == {"tokens", "labels", "patch_embeds", "positions"}
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])
    assert ours["labels"].shape == (2, cfg.n_patches + 16)
    assert (ours["labels"][:, :cfg.n_patches] == -1).all()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_reduced_qwen2_vl_loss_prefill_decode_match_jax(dtype, monkeypatch):
    """loss_fn on both attention paths (8 patches and 56 tokens: S = 64 takes
    the flash wrapper in every layer, causal at a group of 2; a raised
    chunked_attn_min_len the direct path), prefill of the patches and 24
    tokens, and 3 decode steps with the batch's M-RoPE positions, against
    the JAX package's jitted functions, on Qwen2-VL's grid positions."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models(dtype)
    tol = F32 if dtype == "fp32" else BF16
    batch = _batch(tcfg, 2, 64 - tcfg.n_patches, seed=3)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, **kw: calls.append((q.shape, k.shape)) or
                        real(q, k, v, **kw))
    jloss, jmetrics = jax.jit(jmodel.loss_fn)(jparams, batch)
    for min_len, launches in ((64, tcfg.n_layers), (1 << 30, 0)):
        calls.clear()
        model = DecoderModel(dataclasses.replace(tcfg, chunked_attn_min_len=min_len),
                             device="cpu")
        with torch.no_grad():
            loss, metrics = model.loss_fn(tparams, batch)
        assert len(calls) == launches
        _close(loss, jloss, tol)
        n_text = 2 * (64 - tcfg.n_patches)       # the patches' labels are -1
        assert float(metrics["tokens"]) == float(jmetrics["tokens"]) == n_text
    assert calls == []
    prompt = _prefix(batch, 24)
    out = tmodel.prefill_fn(tparams, prompt)
    jout = jax.jit(jmodel.prefill_fn)(jparams, prompt)
    ref = ref_decode = None
    if dtype == "bf16":
        # the JAX fp32 forward of the same (bf16) weights: bf16's yardstick
        f32 = dataclasses.replace(jcfg, dtype=jnp.float32, param_dtype=jnp.float32)
        ref_model = jbuild_model(f32)
        ref_params = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
        ref = jax.jit(ref_model.prefill_fn)(ref_params, prompt)
        ref_decode = jax.jit(ref_model.decode_fn)

    def held(got, want, key, ref_value):
        if ref_value is None:
            _close(got, want, tol)
        else:
            _noise_close(got, want, ref_value, key)

    held(out["logits"], jout["logits"], "prefill logits", ref and ref["logits"])
    for key in ("k", "v"):
        assert tuple(out["cache"][key].shape) == tuple(jout["cache"][key].shape)
        held(out["cache"][key], jout["cache"][key], key, ref and ref["cache"][key])
    cache, jcache = out["cache"], jout["cache"]
    jdecode = jax.jit(jmodel.decode_fn)
    side = int(round(tcfg.n_patches ** 0.5))
    for step in range(3):
        tok = {"tokens": batch["tokens"][:, 24 + step:25 + step],
               "positions": np.full((2, 3, 1), side + 24 + step, np.int32)}
        cache, logits = tmodel.decode_fn(tparams, cache, tok)
        jcache, jlogits = jdecode(jparams, jcache, tok)
        ref_logits = None
        if ref is not None:
            rcache, ref_logits = ref_decode(ref_params, ref["cache"], tok)
            ref = {"cache": rcache}
        held(logits, jlogits, f"decode step {step} logits", ref_logits)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_vlm_cache_invariant_on_qwen2_vl_positions(dtype):
    """prefill(patches, t) against prefill(patches, t[:-1]) + decode(t[-1])
    at the M-RoPE position the batch gives it (the grid's side + 15), on
    the port alone. A decode step that takes its rotary positions from the
    cache's index (8 + 15) instead lands elsewhere: the invariant is what
    catches a decode that ignores the batch's positions."""
    _, tcfg, _, _, tmodel, tparams = _models(dtype, seed=1)
    tol = F32 if dtype == "fp32" else BF16
    batch = _batch(tcfg, 2, 16, seed=4)
    full = tmodel.prefill_fn(tparams, _prefix(batch, 16))
    short = tmodel.prefill_fn(tparams, _prefix(batch, 15))
    last = batch["tokens"][:, 15:16]
    pos = batch["positions"][:, :, -1:]
    assert (pos == int(round(tcfg.n_patches ** 0.5)) + 15).all()
    cache, dec = tmodel.decode_fn(tparams, short["cache"], {"tokens": last, "positions": pos})
    _close(dec, full["logits"], tol)
    assert cache["pos"].tolist() == [tcfg.n_patches + 16] * tcfg.n_layers
    short = tmodel.prefill_fn(tparams, _prefix(batch, 15))
    index = np.full((2, 3, 1), tcfg.n_patches + 15, np.int32)
    _, wrong = tmodel.decode_fn(tparams, short["cache"], {"tokens": last, "positions": index})
    assert not np.allclose(_np(wrong), _np(full["logits"]), **tol)


def test_qwen2_vl_gradients_match_jax():
    """jax.grad(loss_fn) against the port's loss.backward() in fp32 on the
    flash path (S = 64), every parameter: the QKV biases and the untied
    head included (the patches are inputs, not parameters)."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models(seed=1)
    batch = _batch(tcfg, 2, 64 - tcfg.n_patches, seed=4)
    loss, _ = tmodel.loss_fn(tparams, batch)
    loss.backward()
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for n, p in tparams.named_parameters():
        want = _np(tt.param_leaf(jgrads, n)[1])
        atol = max(1e-5 * float(np.abs(want).max()), 1e-8)
        np.testing.assert_allclose(_np(p.grad), want, rtol=1e-4, atol=atol, err_msg=n)


def test_qwen2_vl_params_from_numpy_refuses_missing_and_extra_leaves():
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, tcfg, device="cpu")
    names = dict(params.named_parameters())
    assert {"embed", "unembed", "layers.1.attn.bq", "layers.0.attn.bk",
            "ln_final.scale"} <= set(names)
    np.testing.assert_array_equal(_np(names["unembed"]), tree["unembed"])
    with pytest.raises(ValueError, match="leaves with no parameter"):
        params_from_numpy(dict(tree, patch_proj=np.zeros((3, 3), np.float32)), tcfg,
                          device="cpu")
    with pytest.raises(KeyError, match="unembed"):
        params_from_numpy({k: v for k, v in tree.items() if k != "unembed"}, tcfg,
                          device="cpu")


def test_build_model_gives_the_decoder_with_the_vlm_branch():
    model = build_model(reduced(get_config("qwen2-vl-7b")), device="cpu")
    assert type(model) is DecoderModel and model.cfg.family == "vlm"
    assert get_config("qwen2-vl-7b").mrope_sections == (16, 24, 24)
    assert sum(get_config("qwen2-vl-7b").mrope_sections) == get_config("qwen2-vl-7b").hd // 2
