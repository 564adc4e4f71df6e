"""The port's Mamba2 and Zamba2 hybrid (`repro_torch/models/mamba.py`,
`models/zamba.py`, the hybrid family of zamba2-7b) against the JAX package
on the CPU, and the flash kernel's plain version at zamba2-7b's head width
of 112 against the JAX Pallas kernel in interpret mode.

The same numpy inputs, drawn under a seed, go through each JAX function and
its port: the SSD step and chunked scan (with `fold_decay` off and on), the
Mamba2 block from zero and from a carried state, and the reduced
zamba2-7b's loss_fn (on the flash route and the direct one), prefill_fn and
decode_fn, with the JAX parameters carried across by `params_from_numpy`.
On the CPU the flash route is the kernel's plain version.

Tolerances: fp32 rtol = atol = 1e-4 for functions, states and the whole
reduced model; bf16 3e-2, the JAX package's own (tests/test_models.py:79),
for logits, losses and the fp32 SSM states, while the bf16 caches of raw
activations (conv inputs, K, V) are held to the JAX package's own distance
from its fp32 forward (`_noise_close`, chip_smoke.py's noise-floor rule);
the flash plain version against the interpret-mode kernel at the
reference's own flash tolerance, 3e-4 in fp32 (tests/test_kernels.py:88).
Remat on and off: gradients equal bit for bit (the same operations,
recomputed). The reduced model's fp32 gradients against `jax.grad` of the
JAX loss: rtol 1e-4 and an atol of 1e-5 of each parameter's largest
gradient magnitude, tests/test_torch_dense.py's (`_close_to_max`).
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
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ZambaModel, build_model, params_from_numpy  # noqa: E402
from repro_torch.models import mamba as tmamba, transformer as tt, zamba as tzamba  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
FLASH_F32 = dict(rtol=3e-4, atol=3e-4)
NOISE_FACTOR = 1.25    # chip_smoke.py's bf16 noise-floor factor
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
CPU = torch.device("cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol=F32):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _cfgs(dtype="fp32", **upd):
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jreduced(jget_config("zamba2-7b")), dtype=jdt, param_dtype=jdt,
                               **upd)
    tcfg = dataclasses.replace(reduced(get_config("zamba2-7b")), dtype=tdt, param_dtype=tdt,
                               **upd)
    return jcfg, tcfg


def _models(dtype="fp32", seed=0, **upd):
    jcfg, tcfg = _cfgs(dtype, **upd)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jmodel, jparams, ZambaModel(tcfg, device="cpu"), tparams


def _ssd_inputs(rng, b, s, h, p, g, n):
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)) - 2.0)).astype(np.float32)
    a = -np.exp(np.log(np.linspace(1.0, 16.0, h))).astype(np.float32)
    b_in, c_in = (rng.normal(size=(b, s, g, n)).astype(np.float32) for _ in range(2))
    state = (0.5 * rng.normal(size=(b, h, n, p))).astype(np.float32)
    return x, dt, a, b_in, c_in, state


def _pair(arrays):
    return (tuple(torch.tensor(a) for a in arrays), tuple(jnp.asarray(a) for a in arrays))


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------
def test_ssd_step_matches_jax():
    """One step with 2 groups of B and C over 6 heads (each group read by 3)."""
    rng = np.random.default_rng(0)
    x, dt, a, b_in, c_in, state = _ssd_inputs(rng, 2, 1, 6, 8, 2, 5)
    ins, jins = _pair((x[:, 0], dt[:, 0], a, b_in[:, 0], c_in[:, 0], state))
    y, h = tmamba.ssd_step(*ins)
    jy, jh = jmamba.ssd_step(*jins)
    _close(y, jy)
    _close(h, jh)


@pytest.mark.parametrize("fold_decay", [False, True])
@pytest.mark.parametrize("s,chunk", [(37, 16), (32, 16)])
def test_ssd_chunked_matches_jax_and_the_steps(s, chunk, fold_decay):
    """From a non-zero state, 2 groups over 6 heads; S = 37 is no multiple
    of the chunk (its zero padding neither decays nor feeds the state)."""
    rng = np.random.default_rng(1)
    arrays = _ssd_inputs(rng, 2, s, 6, 8, 2, 5)
    ins, jins = _pair(arrays)
    y, h = tmamba.ssd_chunked(*ins, chunk=chunk, fold_decay=fold_decay)
    jy, jh = jmamba.ssd_chunked(*jins, chunk=chunk, fold_decay=fold_decay)
    _close(y, jy)
    _close(h, jh)
    # the recurrence, one step a position
    x, dt, a, b_in, c_in, st = ins
    ys = []
    for t in range(s):
        yt, st = tmamba.ssd_step(x[:, t], dt[:, t], a, b_in[:, t], c_in[:, t], st)
        ys.append(yt)
    _close(y, torch.stack(ys, dim=1))
    _close(h, st)


def test_ssd_chunked_gradient_is_finite_where_the_masked_decay_overflows():
    """Steep decays (a dt down to -16 x 5 a step): inside a chunk the masked
    exponents acum_t - acum_s (t < s) pass fp32's range, as they do at
    zamba2-7b's full width. The port takes exp of the masked ones at -inf,
    so its gradient is finite and the recurrence's (one ssd_step a
    position). The JAX package's jnp.where(tri, exp(seg), 0) sends
    0 x inf = NaN back there: a fault of the reference, recorded here."""
    rng = np.random.default_rng(3)
    arrays = list(_ssd_inputs(rng, 1, 32, 4, 8, 2, 5))
    arrays[1] = arrays[1] + np.float32(3.0)                  # dt of 3 to 5
    wy = rng.normal(size=(1, 32, 4, 8)).astype(np.float32)
    wh = rng.normal(size=(1, 4, 5, 8)).astype(np.float32)

    def grads(run):
        leaves = [torch.tensor(a).requires_grad_() for a in arrays]
        y, h = run(*leaves)
        loss = (y * torch.tensor(wy)).sum() + (h * torch.tensor(wh)).sum()
        return torch.autograd.grad(loss, leaves)

    def steps(x, dt, a, b_in, c_in, st):
        ys = []
        for t in range(x.shape[1]):
            yt, st = tmamba.ssd_step(x[:, t], dt[:, t], a, b_in[:, t], c_in[:, t], st)
            ys.append(yt)
        return torch.stack(ys, dim=1), st

    got = grads(lambda *a: tmamba.ssd_chunked(*a, chunk=16))
    want = grads(steps)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()))

    def jloss(*a):
        y, h = jmamba.ssd_chunked(*a, chunk=16)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in arrays))
    assert not all(bool(jnp.isfinite(g).all()) for g in jgrads)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("start", ["zero", "carried", "step"])
def test_mamba2_block_matches_jax(start, dtype):
    """The block without a state (S = 40: two chunks of 16 and a padded
    one), from a carried SSM state and conv cache (S = 40), and one decode
    step from it (ssd_step)."""
    jcfg, tcfg = _cfgs(dtype, ssm_chunk=16)
    tol = F32 if dtype == "fp32" else BF16
    jp = jax.tree.map(np.asarray, jmamba.init_mamba2_block(jax.random.PRNGKey(2), jcfg))
    block = tmamba.Mamba2Block(tcfg, generator=None, device=CPU)
    with torch.no_grad():
        for name, p in block.named_parameters():
            leaf = jp
            for key in name.split("."):
                leaf = leaf[key]
            p.copy_(torch.tensor(np.asarray(leaf, np.float32)).to(p.dtype))
    assert block.a_log.dtype == block.dt_bias.dtype == block.d_skip.dtype == torch.float32
    rng = np.random.default_rng(3)
    s = 1 if start == "step" else 40
    x = rng.normal(size=(2, s, tcfg.d_model)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    st = jst = None
    if start != "zero":
        m0 = tmamba.mamba2_init_state(tcfg, 2)
        h0 = (0.5 * rng.normal(size=tuple(m0.h.shape))).astype(np.float32)
        c0 = rng.normal(size=tuple(m0.conv.shape)).astype(np.float32)
        st = tmamba.Mamba2State(torch.tensor(h0), torch.tensor(c0).to(tdt))
        jst = jmamba.Mamba2State(jnp.asarray(h0), jnp.asarray(c0, jdt))
    out, new = tmamba.mamba2_block(block, torch.tensor(x).to(tdt), tcfg, st)
    jout, jnew = jmamba.mamba2_block(jp, jnp.asarray(x, jdt), jcfg, jst)
    _close(out, jout, tol)
    if start == "zero":
        assert new is None and jnew is None
    else:
        _close(new.h, jnew.h, tol)
        _close(new.conv, jnew.conv, tol)


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------
def _noise_close(got, want, ref32, what):
    """A bf16 tensor of the port no farther from the fp32 forward's than the
    JAX package's bf16 tensor, within NOISE_FACTOR in mean and in root mean
    square (the largest of a few thousand rounding differences is one
    entry's luck: 1.38 times JAX's in one of these runs, the means 0.9)."""
    ref32 = _np(ref32)
    eg, ej = np.abs(_np(got) - ref32), np.abs(_np(want) - ref32)
    assert eg.mean() <= NOISE_FACTOR * ej.mean(), (what, eg.mean(), ej.mean())
    rg, rj = np.sqrt((eg ** 2).mean()), np.sqrt((ej ** 2).mean())
    assert rg <= NOISE_FACTOR * rj, (what, rg, rj)


def _states_close(got, want, tol, ref32=None):
    """The caches against the JAX package's. With `ref32` (bf16 runs), the
    raw bf16 activations the caches hold (the conv inputs, K and V) are held
    by `_noise_close`: past the first layer the two packages' bf16 values
    lie a few bf16 ulps apart (XLA's CPU lowering rounds each op of, e.g.,
    jax.nn.silu's 1 / (1 + e^-x) to bf16, PyTorch rounds each function
    once), beyond 3e-2 at a few entries of values near 1. The fp32 SSM
    state and the fp32 run are held at tol."""
    for key in ("mamba_h", "mamba_conv", "attn_k", "attn_v"):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        if ref32 is not None and key != "mamba_h":
            _noise_close(got[key], want[key], ref32[key], key)
        else:
            _close(got[key], want[key], tol)
    np.testing.assert_array_equal(got["attn_pos"].numpy(), np.asarray(want["attn_pos"]))


def _fp32_reference(jcfg, jparams, prompt):
    """The JAX package's fp32 prefill of `prompt` with the bf16 weights cast
    to fp32, and a function taking its cache one decode step on."""
    f32 = dataclasses.replace(jcfg, dtype=jnp.float32, param_dtype=jnp.float32)
    model = jbuild_model(f32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    decode = jax.jit(model.decode_fn)

    def step(out, tok):
        cache, logits = decode(params, out["cache"], tok)
        return {"cache": cache, "logits": logits}

    return jax.jit(model.prefill_fn)(params, prompt), step


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_reduced_zamba_loss_prefill_decode_match_jax(dtype, monkeypatch):
    """loss_fn on both attention paths (S = 64 >= chunked_attn_min_len takes
    the flash wrapper once a group; a raised chunked_attn_min_len the direct
    path), prefill of 32 tokens and 3 decode steps against the JAX
    package's jitted functions, caches and states included."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models(dtype)
    tol = F32 if dtype == "fp32" else BF16
    batch = TokenStream(tcfg, 2, 64, seed=3)(0)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jloss, jmetrics = jax.jit(jmodel.loss_fn)(jparams, batch)
    n_groups = tzamba.zamba_groups(tcfg)[0]
    for min_len, launches in ((64, n_groups), (1 << 30, 0)):
        calls.clear()
        model = ZambaModel(dataclasses.replace(tcfg, chunked_attn_min_len=min_len), device="cpu")
        with torch.no_grad():
            loss, metrics = model.loss_fn(tparams, batch)
        assert len(calls) == launches
        _close(loss, jloss, tol)
        assert float(metrics["tokens"]) == float(jmetrics["tokens"])
    calls.clear()
    prompt = {"tokens": batch["tokens"][:, :32]}
    out = tmodel.prefill_fn(tparams, prompt)
    jout = jax.jit(jmodel.prefill_fn)(jparams, prompt)
    _close(out["logits"], jout["logits"], tol)
    # the JAX fp32 forward of the same (bf16) weights: the bf16 caches' yardstick
    ref, ref_decode = _fp32_reference(jcfg, jparams, prompt) if dtype == "bf16" else (None, None)
    _states_close(out["cache"], jout["cache"], tol, ref and ref["cache"])
    cache, jcache = out["cache"], jout["cache"]
    jdecode = jax.jit(jmodel.decode_fn)
    for step in range(3):
        tok = {"tokens": batch["tokens"][:, 32 + step:33 + step]}
        cache, logits = tmodel.decode_fn(tparams, cache, tok)
        jcache, jlogits = jdecode(jparams, jcache, tok)
        _close(logits, jlogits, tol)
        if ref is not None:
            ref = ref_decode(ref, tok)
    _states_close(cache, jcache, tol, ref and ref["cache"])
    assert not calls


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_zamba_cache_invariant(dtype):
    """prefill(t) against prefill(t[:-1]) + decode(t[-1]) on the port alone:
    the chunked SSD against its prefix and one step, and the shared block's
    K/V caches, one a group."""
    _, tcfg, _, _, tmodel, tparams = _models(dtype, seed=1)
    tol = F32 if dtype == "fp32" else BF16
    toks = torch.as_tensor(TokenStream(tcfg, 2, 33, seed=4)(0)["tokens"])
    full = tmodel.prefill_fn(tparams, {"tokens": toks})
    short = tmodel.prefill_fn(tparams, {"tokens": toks[:, :-1]})
    cache, dec = tmodel.decode_fn(tparams, short["cache"], {"tokens": toks[:, -1:]})
    _close(dec, full["logits"], tol)
    for key in ("mamba_h", "mamba_conv"):
        _close(cache[key], full["cache"][key], tol)
    np.testing.assert_array_equal(cache["attn_pos"].numpy(), [33] * len(cache["attn_pos"]))


def test_zamba_shared_block_is_applied_with_one_set_of_weights():
    """The shared block's parameters appear once; each group's application
    reads them: perturbing them moves the output of every group."""
    _, tcfg, _, jparams, tmodel, tparams = _models()
    names = [n for n, _ in tparams.named_parameters() if n.startswith("shared.")]
    assert sorted(names) == sorted(
        "shared." + "/".join(p).replace("/", ".")
        for p in _paths(jax.tree.map(np.asarray, jparams["shared"])))
    seen = []
    real = tzamba.shared_block
    mp = pytest.MonkeyPatch()
    mp.setattr(tzamba, "shared_block",
               lambda p, *a, **k: seen.append(p) or real(p, *a, **k))
    try:
        with torch.no_grad():
            tmodel.loss_fn(tparams, TokenStream(tcfg, 1, 16, seed=5)(0))
    finally:
        mp.undo()
    assert len(seen) == tzamba.zamba_groups(tcfg)[0] and all(p is tparams.shared for p in seen)


def _close_to_max(got, want, *, rtol=1e-4, frac=1e-5):
    got, want = _np(got), _np(want)
    atol = frac * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("path", ["flash", "direct"])
def test_reduced_zamba_gradients_match_jax(path, monkeypatch):
    """jax.grad(model.loss_fn) against the port's loss.backward() in fp32,
    for every parameter. The reduced zamba has two groups, so the tied
    shared block's gradient is the sum over its two applications. The
    flash path (S = 64) runs at zamba2-7b's head width of 112: the flash
    forward and its backward's plain version once an application; the
    direct path (S = 32) launches neither."""
    upd = dict(head_dim=112) if path == "flash" else {}
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models(seed=1, **upd)
    n_groups, n_per = tzamba.zamba_groups(tcfg)
    assert n_groups == 2
    batch = TokenStream(tcfg, 2, 64 if path == "flash" else 32, seed=4)(0)
    calls = {"flash_attention": [], "flash_attention_bwd": []}
    for name, seen in calls.items():
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _s=seen, **k:
                            _s.append(a[0].shape) or _r(*a, **k))
    loss, _ = tmodel.loss_fn(tparams, batch)
    loss.backward()
    want = [(2 * tcfg.n_heads, 64, 112)] * n_groups if path == "flash" else []   # B = 2
    assert calls == {"flash_attention": want, "flash_attention_bwd": want}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    # one port parameter a JAX leaf, a Mamba2 leaf's (group, layer) slices each one
    leaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(list(tparams.parameters())) == sum(
        n_groups * n_per if kp[0].key == "mamba" else 1 for kp, _ in leaves)
    for n, p in tparams.named_parameters():
        _close_to_max(p.grad, tt.param_leaf(jgrads, n)[1])
    assert float(tparams.shared.attn.wq.grad.abs().max()) > 0


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix


def test_zamba_params_from_numpy_refuses_missing_and_extra_leaves():
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, tcfg, device="cpu")
    names = dict(params.named_parameters())
    assert {"mamba.1.0.in_proj", "mamba.0.1.a_log", "shared.attn.wq", "shared.mlp.w_gate",
            "shared.ln_attn.scale", "ln_final.scale", "embed"} <= set(names)
    np.testing.assert_array_equal(_np(names["mamba.1.1.out_proj"]),
                                  tree["mamba"]["out_proj"][1, 1])
    bf = params_from_numpy(tree, dataclasses.replace(tcfg, param_dtype=torch.bfloat16,
                                                     dtype=torch.bfloat16), device="cpu")
    for name, p in bf.named_parameters():
        fp32 = name.split(".")[-1] in ("a_log", "dt_bias", "d_skip")
        assert p.dtype == (torch.float32 if fp32 else torch.bfloat16), name
    with pytest.raises(ValueError, match="leaves with no parameter"):
        params_from_numpy(dict(tree, shared=dict(tree["shared"], extra=np.zeros(3))), tcfg,
                          device="cpu")
    mamba = {k: v for k, v in tree["mamba"].items() if k != "dt_bias"}
    with pytest.raises(KeyError, match="dt_bias"):
        params_from_numpy(dict(tree, mamba=mamba), tcfg, device="cpu")
    # a third Mamba2 layer a group stacked in the tree is a slice too many
    grown = jax.tree.map(lambda a: np.concatenate([a, a[:, :1]], axis=1), tree["mamba"])
    with pytest.raises(ValueError, match="mamba/"):
        params_from_numpy(dict(tree, mamba=grown), tcfg, device="cpu")


def test_build_model_gives_the_hybrid():
    assert isinstance(build_model(reduced(get_config("zamba2-7b")), device="cpu"), ZambaModel)


# ---------------------------------------------------------------------------
# the flash kernel's plain version at D = 112
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bh,bhk,s", [(2, 2, 256), (4, 2, 200)])
def test_flash_plain_version_at_d112_matches_pallas_interpret(bh, bhk, s):
    """zamba2-7b's head width: the plain version the card's kernel is held
    to, against the JAX Pallas kernel in interpret mode (causal; MHA, and a
    ragged S over 2 KV heads)."""
    rng = np.random.default_rng(8)
    q = rng.normal(size=(bh, s, 112)).astype(np.float32)
    k, v = (rng.normal(size=(bhk, s, 112)).astype(np.float32) for _ in range(2))
    got = ref.flash_attention_ref(*(torch.tensor(a) for a in (q, k, v)), causal=True)
    # the Pallas kernel reads K/V block b for query block b, and takes S in
    # whole tiles: each query head gets its KV head's copy, and the JAX
    # wrapper pads the ragged S
    kr, vr = (jnp.repeat(jnp.asarray(a), bh // bhk, axis=0) for a in (k, v))
    want = jops.flash_attention(jnp.asarray(q), kr, vr, causal=True, interpret=True)
    if s % 128 == 0:
        _close(flash_attention_pallas(jnp.asarray(q), kr, vr, causal=True, interpret=True),
               want, dict(rtol=0, atol=0))
    _close(got, want, FLASH_F32)
    # and through the wrapper, which on the CPU is the plain version
    _close(ops.flash_attention(*(torch.tensor(a) for a in (q, k, v))), got, dict(rtol=0, atol=0))
    assert 112 in ops.FLASH_HEAD_DIMS and 112 in ops.FLASH_BWD_HEAD_DIMS


# ---------------------------------------------------------------------------
# remat: each Mamba2 block recomputed in the backward
# ---------------------------------------------------------------------------
def _grads_and_saved_bytes(model, params, batch):
    """(loss, {name: grad}, bytes autograd saved outside any checkpoint)
    of one loss_fn and its backward. A checkpoint's own saved tensors go
    through its own hooks, which sit inside the counting ones."""
    for p in params.parameters():
        p.grad = None
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = model.loss_fn(params, batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in params.named_parameters()}, saved[0]


@pytest.mark.parametrize("seq", [64, 32])
def test_zamba_remat_recomputes_each_mamba2_block(seq, monkeypatch):
    """Under grad with cfg.remat each Mamba2 block runs under
    torch.utils.checkpoint, as the JAX package's jax.checkpoint(m_body),
    on both attention paths of the shared block (S = 64 takes the flash
    wrapper, 32 the direct path): the gradients are those without remat
    bit for bit, autograd keeps fewer bytes, and each block's forward runs
    a second time in the backward. The shared block stays outside the
    checkpoint (applied once a group)."""
    _, tcfg, _, _, _, tparams = _models()
    batch = TokenStream(tcfg, 2, seq, seed=3)(0)
    calls = {"mamba2_block": 0, "shared_block": 0}
    for name in calls:
        real = getattr(tzamba, name)

        def counted(*a, _r=real, _n=name, **k):
            calls[_n] += 1
            return _r(*a, **k)
        monkeypatch.setattr(tzamba, name, counted)
    n_groups, n_per = tzamba.zamba_groups(tcfg)
    runs = {}
    for remat in (False, True):
        calls.update(mamba2_block=0, shared_block=0)
        model = ZambaModel(dataclasses.replace(tcfg, remat=remat), device="cpu")
        runs[remat] = _grads_and_saved_bytes(model, tparams, batch) + (dict(calls),)
    (l0, g0, b0, c0), (l1, g1, b1, c1) = runs[False], runs[True]
    assert l0 == l1
    for name, g in g0.items():
        assert torch.equal(g, g1[name]), name
    assert b1 < b0, (b1, b0)
    assert c0 == {"mamba2_block": n_groups * n_per, "shared_block": n_groups}
    assert c1 == {"mamba2_block": 2 * n_groups * n_per, "shared_block": n_groups}
