"""The port's other dense configs (smollm-360m, stablelm-1.6b, granite-20b)
against the JAX package on the CPU.

Their features beside gemma2-2b's: layer norm (stablelm), an untied head
(stablelm, granite-20b), the ungated GELU MLP (granite-20b), MQA and MHA,
and the QKV biases, which no published config sets and which are tested on
`dataclasses.replace(reduced(...), qkv_bias=True)` with non-zero biases
carried across. Inputs and parameters come from numpy under a seed (the
JAX parameters are carried across with `params_from_numpy`). The port's
flash path on the CPU is the kernel's plain version.

Tolerances, and why:
  * layers in fp32: 1e-5; the same fp32 arithmetic, summed in other orders.
  * the whole reduced model in fp32: rtol/atol 1e-4 on loss, logits and
    caches, as tests/test_torch_lm.py holds gemma2-2b.
  * the whole reduced model in bf16: 3e-2, the JAX package's bf16
    tolerance (tests/test_models.py:78).
  * gradients in fp32: rtol 1e-4 and an atol of 1e-5 of each parameter's
    largest gradient magnitude, as tests/test_torch_train.py holds
    gemma2-2b's.
  * three training steps in fp32: loss, grad_norm and lr at rtol 1e-5, the
    parameters at rtol 1e-4 and atol 1e-6 (tests/test_torch_train.py)
    except for at most one entry in 1,000 of a tensor, and every entry
    within 2 lr. An AdamW step moves an entry by about lr times the sign
    of its gradient, and where a gradient lies within the two packages'
    fp32 noise of zero the signs may differ: 2 of stablelm's 65,536
    embedding entries do, 5.3e-5 apart (the rule
    tests/test_torch_cuda.py holds the card's step to against the CPU's).
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
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import layers as jl, transformer as jt  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import DecoderModel, params_from_numpy  # noqa: E402
from repro_torch.models import layers as tl, transformer as tt  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

DENSE = ("smollm-360m", "stablelm-1.6b", "granite-20b")
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
LAYER = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _cfgs(name, dtype="fp32", **upd):
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jreduced(jget_config(name)), dtype=jdt, param_dtype=jdt, **upd)
    tcfg = dataclasses.replace(reduced(get_config(name)), dtype=tdt, param_dtype=tdt, **upd)
    return jcfg, tcfg


def _copy_into(module, tree):
    """Each parameter of a port module from the JAX tree's leaf of its name."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = tree
            for key in name.split("."):
                leaf = leaf[key]
            p.copy_(torch.tensor(np.asarray(leaf, np.float32)).to(p.dtype))


def _models(name, dtype="fp32", seed=0, **upd):
    jcfg, tcfg = _cfgs(name, dtype, **upd)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jmodel, jparams, DecoderModel(tcfg, device="cpu"), tparams


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
def test_layer_norm_matches_jax():
    rng = np.random.default_rng(5)
    x = (3.0 + 2.0 * rng.normal(size=(2, 6, 64))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=(64,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(64,))).astype(np.float32)
    for eps in (1e-6, 1e-5):
        _close(tl.layer_norm(*(torch.tensor(a) for a in (x, scale, bias)), eps),
               jl.layer_norm(*(jnp.asarray(a) for a in (x, scale, bias)), eps), LAYER)
    got = tl.layer_norm(*(torch.tensor(a).bfloat16() for a in (x, scale, bias)), 1e-6)
    want = jl.layer_norm(*(jnp.asarray(a, jnp.bfloat16) for a in (x, scale, bias)), 1e-6)
    assert got.dtype == torch.bfloat16
    _close(got, want, dict(rtol=2.0 ** -7, atol=2.0 ** -7))


def test_norm_modules_follow_the_jax_init():
    """init_norm by cfg.norm_type: layer norm's scale ones and bias zeros,
    RMS norm's scale zeros (applied as 1 + scale)."""
    jcfg, tcfg = _cfgs("stablelm-1.6b")
    norm = tt.init_norm(tcfg, device=CPU)
    want = jt.init_norm(jcfg)
    assert sorted(n for n, _ in norm.named_parameters()) == sorted(want)
    for n, p in norm.named_parameters():
        np.testing.assert_array_equal(_np(p), np.asarray(want[n], np.float32))
    x = np.random.default_rng(1).normal(size=(2, 5, tcfg.d_model)).astype(np.float32)
    _close(tt.apply_norm(norm, torch.tensor(x), tcfg), jt.apply_norm(want, jnp.asarray(x), jcfg),
           LAYER)
    assert isinstance(tt.init_norm(_cfgs("smollm-360m")[1], device=CPU), tt.RMSNorm)
    with pytest.raises(ValueError, match="norm_type"):
        tt.init_norm(dataclasses.replace(tcfg, norm_type="batch"), device=CPU)


@pytest.mark.parametrize("seq,min_len", [(64, 64), (64, 1 << 30), (40, 64)])
def test_attention_with_qkv_bias_matches_jax(seq, min_len):
    """attention_block with non-zero QKV biases, added after the
    projections and before RoPE, on the flash path (seq >= min_len) and
    the direct one; MHA (stablelm's kv = n_heads)."""
    jcfg, tcfg = _cfgs("stablelm-1.6b", qkv_bias=True, chunked_attn_min_len=min_len)
    jp = jax.tree.map(np.asarray, jl.init_attention(jax.random.PRNGKey(2), jcfg))
    rng = np.random.default_rng(3)
    for key in ("bq", "bk", "bv"):
        assert not np.asarray(jp[key]).any()        # zeros at init in both
        jp[key] = (0.5 * rng.normal(size=jp[key].shape)).astype(np.float32)
    attn = tl.init_attention(tcfg, generator=torch.Generator().manual_seed(0), device=CPU)
    assert not any(attn.get_parameter(k).any() for k in ("bq", "bk", "bv"))
    _copy_into(attn, jp)
    x = rng.normal(size=(2, seq, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (2, seq))
    calls = []
    real = ops.flash_attention
    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    try:
        with torch.no_grad():
            got, _ = tl.attention_block(attn, torch.tensor(x), tcfg,
                                        positions=torch.tensor(pos.copy()))
    finally:
        mp.undo()
    assert len(calls) == (1 if seq >= min_len else 0)
    want, _ = jl.attention_block(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos))
    _close(got, want, dict(rtol=5e-4, atol=5e-4) if calls else LAYER)
    # the biases count: dropped, the output moves
    with torch.no_grad():
        for key in ("bq", "bk", "bv"):
            attn.get_parameter(key).zero_()
        unbiased, _ = tl.attention_block(attn, torch.tensor(x), tcfg,
                                         positions=torch.tensor(pos.copy()))
    assert not np.allclose(_np(unbiased), _np(want), rtol=1e-3, atol=1e-3)


def test_ungated_gelu_mlp_matches_jax():
    """granite-20b's classic MLP: gelu (tanh) of x w_up, then w_down, and no
    w_gate leaf."""
    jcfg, tcfg = _cfgs("granite-20b")
    jp = jax.tree.map(np.asarray, jl.init_mlp(jax.random.PRNGKey(1), jcfg))
    mlp = tl.init_mlp(tcfg, generator=None, device=CPU)
    assert sorted(n for n, _ in mlp.named_parameters()) == sorted(jp) == ["w_down", "w_up"]
    _copy_into(mlp, jp)
    x = 3.0 * np.random.default_rng(6).normal(size=(2, 5, tcfg.d_model)).astype(np.float32)
    with torch.no_grad():
        got = tl.mlp_block(mlp, torch.tensor(x), tcfg)
    _close(got, jl.mlp_block(jp, jnp.asarray(x), jcfg), LAYER)


@pytest.mark.parametrize("name", ["stablelm-1.6b", "granite-20b"])
def test_untied_head_matches_jax(name):
    """decoder_forward's logits through the (d_model, vocab) unembed, and
    head_loss through the same head: its transposed view, not a copy."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models(name)
    assert "unembed" in jparams and tuple(tparams.unembed.shape) == (tcfg.d_model,
                                                                      tcfg.vocab_size)
    w = tt.head_weight(tparams, tcfg)
    assert w.data_ptr() == tparams.unembed.data_ptr() and not w.is_contiguous()
    batch = TokenStream(tcfg, 2, 32, seed=2)(0)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    with torch.no_grad():
        logits = tt.decoder_forward(tparams, tcfg, torch.as_tensor(batch["tokens"]),
                                    positions=torch.tensor(pos.copy()))[0]
        loss, _ = tmodel.loss_fn(tparams, batch)
    jlogits = jt.decoder_forward(jparams, jcfg, jnp.asarray(batch["tokens"]),
                                 positions=jnp.asarray(pos))[0]
    _close(logits, jlogits, F32)
    _close(loss, tt.cross_entropy(logits, torch.as_tensor(batch["labels"]))[0], F32)
    # the tied embedding is not the head here
    tied = dataclasses.replace(tcfg, tie_embeddings=True)
    with torch.no_grad():
        other = tt.decoder_forward(tparams, tied, torch.as_tensor(batch["tokens"]),
                                   positions=torch.tensor(pos.copy()))[0]
    assert not np.allclose(_np(other), _np(jlogits), rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# the whole reduced models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", DENSE)
def test_reduced_dense_loss_prefill_decode_match_jax(name, dtype, monkeypatch):
    """loss_fn on both attention paths (S = 64 takes the flash wrapper in
    every layer; a raised chunked_attn_min_len the direct path), prefill
    and 3 decode steps, against the JAX package's jitted functions, and
    the cache invariant prefill(t) == prefill(t[:-1]) + decode(t[-1])."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models(name, dtype)
    tol = F32 if dtype == "fp32" else BF16
    batch = TokenStream(tcfg, 2, 64, seed=3)(0)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jloss, jmetrics = jax.jit(jmodel.loss_fn)(jparams, batch)
    for min_len, launches in ((64, tcfg.n_layers), (1 << 30, 0)):
        calls.clear()
        model = DecoderModel(dataclasses.replace(tcfg, chunked_attn_min_len=min_len),
                             device="cpu")
        with torch.no_grad():
            loss, metrics = model.loss_fn(tparams, batch)
        assert len(calls) == launches
        _close(loss, jloss, tol)
        assert float(metrics["tokens"]) == float(jmetrics["tokens"])
        assert float(metrics["aux"]) == float(jmetrics["aux"]) == 0.0

    prompt = {"tokens": batch["tokens"][:, :32]}
    out = tmodel.prefill_fn(tparams, prompt)
    jout = jax.jit(jmodel.prefill_fn)(jparams, prompt)
    _close(out["logits"], jout["logits"], tol)
    for key in ("k", "v"):
        assert out["cache"][key].shape == jout["cache"][key].shape
        _close(out["cache"][key], jout["cache"][key], tol)
    cache, jcache = out["cache"], jout["cache"]
    jdecode = jax.jit(jmodel.decode_fn)
    for step in range(3):
        tok = {"tokens": batch["tokens"][:, 32 + step:33 + step]}
        cache, logits = tmodel.decode_fn(tparams, cache, tok)
        jcache, jlogits = jdecode(jparams, jcache, tok)
        _close(logits, jlogits, tol)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))

    toks = torch.as_tensor(batch["tokens"][:, :33])
    full = tmodel.prefill_fn(tparams, {"tokens": toks})["logits"]
    short = tmodel.prefill_fn(tparams, {"tokens": toks[:, :-1]})
    _, dec = tmodel.decode_fn(tparams, short["cache"], {"tokens": toks[:, -1:]})
    _close(dec, full, tol)


def _port_leaf(jtree, name):
    return tt.param_leaf(jtree, name)[1]


def _close_to_max(got, want, *, rtol=1e-4, frac=1e-5):
    got, want = _np(got), _np(want)
    atol = frac * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("path", ["flash", "direct"])
@pytest.mark.parametrize("name", DENSE)
def test_reduced_dense_gradients_match_jax(name, path):
    """jax.grad(model.loss_fn) against the port's loss.backward() in fp32,
    for every parameter (the norm biases and the untied head included), on
    the flash path (S = 64) and the direct path (S = 32)."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models(name, seed=1)
    batch = TokenStream(tcfg, 2, 64 if path == "flash" else 32, seed=4)(0)
    loss, _ = tmodel.loss_fn(tparams, batch)
    loss.backward()
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    # one port parameter a JAX leaf (a stacked leaf's layer slices each one)
    leaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(list(tparams.parameters())) == sum(
        x.shape[0] if kp[0].key == "layers" else 1 for kp, x in leaves)
    for n, p in tparams.named_parameters():
        _close_to_max(p.grad, _port_leaf(jgrads, n))


def test_reduced_qkv_bias_gradients_match_jax():
    """The biased attention's gradients, biases included, non-zero biases
    carried across from the JAX tree."""
    jcfg, tcfg = _cfgs("stablelm-1.6b", qkv_bias=True)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(7)
    attn = dict(jparams["layers"]["attn"])
    for key in ("bq", "bk", "bv"):
        attn[key] = jnp.asarray(0.3 * rng.normal(size=attn[key].shape), jnp.float32)
    jparams = dict(jparams, layers=dict(jparams["layers"], attn=attn))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    tmodel = DecoderModel(tcfg, device="cpu")
    batch = TokenStream(tcfg, 2, 64, seed=5)(0)
    loss, _ = tmodel.loss_fn(tparams, batch)
    loss.backward()
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for n, p in tparams.named_parameters():
        _close_to_max(p.grad, _port_leaf(jgrads, n))
    assert float(tparams.layers[0].attn.bq.grad.abs().max()) > 0


def test_three_train_steps_match_jax_on_stablelm():
    """make_train_step against the JAX package's jitted step for 3 steps
    from the same state, fp32, flash path: layer norm, the untied head and
    MHA, with their weight decay (the per-layer norm biases decayed, the
    final norm's not, as the JAX leaf ranks say)."""
    jcfg, tcfg, jmodel, jparams, _, tparams = _models("stablelm-1.6b")
    jopt, topt = jadamw.AdamWConfig(lr=1e-3), tadamw.AdamWConfig(lr=1e-3)
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
    for n, p in tparams.named_parameters():
        got, want = _np(p), _np(_port_leaf(jstate.params, n))
        diff = np.abs(got - want)
        assert float(diff.max()) <= 2 * topt.lr, n
        assert int((diff > 1e-6 + 1e-4 * np.abs(want)).sum()) <= max(2, diff.size // 1000), n
    assert tadamw.jax_rank("layers.0.ln_attn.bias", tparams.layers[0].ln_attn.bias) == 2
    assert tadamw.jax_rank("ln_final.bias", tparams.ln_final.bias) == 1


def test_params_from_numpy_takes_the_new_leaves_and_refuses_others():
    jcfg, tcfg = _cfgs("stablelm-1.6b", qkv_bias=True)
    tree = jax.tree.map(np.asarray, jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, tcfg, device="cpu")
    names = {n for n, _ in params.named_parameters()}
    assert {"unembed", "ln_final.bias", "layers.1.ln_mlp.bias", "layers.0.attn.bk"} <= names
    with pytest.raises(ValueError, match="leaves with no parameter"):
        params_from_numpy(dict(tree, extra=np.zeros((3,), np.float32)), tcfg, device="cpu")
    with pytest.raises(KeyError):
        params_from_numpy({k: v for k, v in tree.items() if k != "unembed"}, tcfg,
                          device="cpu")
    untied = dataclasses.replace(tcfg, tie_embeddings=True)
    with pytest.raises(ValueError, match="unembed"):
        params_from_numpy(tree, untied, device="cpu")


def test_prefill_keeps_only_the_last_positions_logits():
    """prefill_fn's logits are (B, V) on storage of their own: a view of the
    last position would keep the whole (B, S, V) fp32 logits alive."""
    _, tcfg = _cfgs("smollm-360m")
    model = DecoderModel(tcfg, device="cpu")
    out = model.prefill_fn(model.init(seed=0), {"tokens": np.zeros((2, 16), np.int32)})
    logits = out["logits"]
    assert tuple(logits.shape) == (2, tcfg.vocab_size)
    assert logits.untyped_storage().nbytes() == logits.numel() * logits.element_size()
