"""The port's xLSTM (`repro_torch/models/ssm.py`, the ssm family of
xlstm-350m) against the JAX package on the CPU.

The same numpy inputs, drawn under a seed, go through each JAX function and
its port: the sequential and chunked mLSTM, the causal conv with and
without its cache, the mLSTM and sLSTM blocks, and the reduced xlstm-350m's
loss_fn, prefill_fn and decode_fn, with the JAX parameters carried across by
`params_from_numpy`. No kernel of the port runs in the xLSTM.

Tolerances: fp32 rtol = atol = 1e-4 for functions, states and the whole
reduced model (the same fp32 arithmetic, summed in other orders); bf16
3e-2, the JAX package's own (tests/test_models.py:79), for logits, losses
and the fp32 recurrent states. The bf16 conv caches, raw bf16 activations,
are held to the JAX package's own distance from its fp32 forward
(`_noise_close`, chip_smoke.py's noise-floor rule). Remat on and off:
gradients equal bit for bit (the same operations, recomputed).
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
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import XLSTMModel, build_model, params_from_numpy  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

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
    jcfg = dataclasses.replace(jreduced(jget_config("xlstm-350m")), dtype=jdt, param_dtype=jdt,
                               **upd)
    tcfg = dataclasses.replace(reduced(get_config("xlstm-350m")), dtype=tdt, param_dtype=tdt,
                               **upd)
    return jcfg, tcfg


def _models(dtype="fp32", seed=0, **upd):
    jcfg, tcfg = _cfgs(dtype, **upd)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jmodel, jparams, XLSTMModel(tcfg, device="cpu"), tparams


def _qkv_gates(rng, b, s, h, d):
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    i_raw = rng.normal(size=(b, s, h)).astype(np.float32)
    f_raw = (2.0 + rng.normal(size=(b, s, h))).astype(np.float32)
    return q, k, v, i_raw, f_raw


def _state(rng, b, h, d):
    """A non-zero mLSTM state, as a few steps of the recurrence leave one."""
    c = (0.3 * rng.normal(size=(b, h, d, d))).astype(np.float32)
    n = (0.3 * rng.normal(size=(b, h, d))).astype(np.float32)
    m = rng.normal(size=(b, h)).astype(np.float32)
    return c, n, m


def _pair(arrays):
    return (tuple(torch.tensor(a) for a in arrays), tuple(jnp.asarray(a) for a in arrays))


# ---------------------------------------------------------------------------
# the mLSTM recurrences
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("start", ["zero", "carried"])
def test_mlstm_sequential_matches_jax(start):
    rng = np.random.default_rng(0)
    b, s, h, d = 2, 12, 3, 8
    ins, jins = _pair(_qkv_gates(rng, b, s, h, d))
    if start == "zero":
        st, jst = tssm.mlstm_init_state(b, h, d, d), jssm.mlstm_init_state(b, h, d, d)
    else:
        st, jst = _pair(_state(rng, b, h, d))
        st, jst = tssm.MLSTMState(*st), jssm.MLSTMState(*jst)
    out, new = tssm.mlstm_sequential(*ins, st)
    jout, jnew = jssm.mlstm_sequential(*jins, jst)
    _close(out, jout)
    for a, ja in zip(new, jnew):
        _close(a, ja)


@pytest.mark.parametrize("s,chunk", [(50, 16), (64, 16), (7, 64)])
def test_mlstm_chunked_matches_jax_and_the_sequential_form(s, chunk):
    """From a non-zero state; S = 50 and 7 are no multiple of the chunk, so
    the gate-neutral padding carries the state through the pad steps."""
    rng = np.random.default_rng(1)
    b, h, d = 2, 3, 8
    ins, jins = _pair(_qkv_gates(rng, b, s, h, d))
    st, jst = _pair(_state(rng, b, h, d))
    out, new = tssm.mlstm_chunked(*ins, tssm.MLSTMState(*st), chunk=chunk)
    jout, jnew = jssm.mlstm_chunked(*jins, jssm.MLSTMState(*jst), chunk=chunk)
    _close(out, jout)
    for a, ja in zip(new, jnew):
        _close(a, ja)
    seq, seq_new = tssm.mlstm_sequential(*ins, tssm.MLSTMState(*st))
    _close(out, seq)
    for a, sa in zip(new, seq_new):
        _close(a, sa)


def test_mlstm_chunked_pads_gate_neutrally():
    """Dropping the padding's gate values (zeros in i and f) would decay
    and feed the carried state through the pad steps: the state differs."""
    rng = np.random.default_rng(2)
    b, s, h, d = 1, 10, 2, 4
    ins, _ = _pair(_qkv_gates(rng, b, s, h, d))
    st, _ = _pair(_state(rng, b, h, d))
    _, new = tssm.mlstm_chunked(*ins, tssm.MLSTMState(*st), chunk=16)
    q, k, v, i_raw, f_raw = (torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, 6))
                             for t in ins)
    _, zero_padded = tssm.mlstm_chunked(q, k, v, i_raw, f_raw, tssm.MLSTMState(*st), chunk=16)
    assert not np.allclose(_np(new.c), _np(zero_padded.c), rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# the causal conv and the blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv1d_matches_jax(with_cache, dtype):
    rng = np.random.default_rng(3)
    jdt, tdt = DTYPES[dtype]
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    w = (0.3 * rng.normal(size=(4, 16))).astype(np.float32)
    cache = rng.normal(size=(2, 3, 16)).astype(np.float32) if with_cache else None
    got, new = tssm.causal_conv1d(torch.tensor(x).to(tdt), torch.tensor(w).to(tdt),
                                  None if cache is None else torch.tensor(cache).to(tdt))
    want, jnew = jssm.causal_conv1d(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                    None if cache is None else jnp.asarray(cache, jdt))
    assert got.dtype == tdt
    _close(got, want, F32 if dtype == "fp32" else dict(rtol=2.0 ** -7, atol=1e-6))
    if with_cache:
        _close(new, jnew)
        np.testing.assert_array_equal(_np(new), x[:, -3:].astype(np.float32) if dtype == "fp32"
                                      else _np(torch.tensor(x[:, -3:]).to(tdt)))
    else:
        assert new is None and jnew is None


@pytest.mark.parametrize("s", [1, 20])
def test_mlstm_block_matches_jax(s):
    """The block from a carried state and conv cache: one position takes
    the sequential form, 20 the chunked one (chunk 8: two whole chunks and
    a padded one)."""
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jssm.init_mlstm_block(jax.random.PRNGKey(4), jcfg))
    block = tssm.MLSTMBlock(tcfg, generator=None, device=torch.device("cpu"))
    with torch.no_grad():
        for name, p in block.named_parameters():
            leaf = jp
            for key in name.split("."):
                leaf = leaf[key]
            p.copy_(torch.tensor(np.asarray(leaf, np.float32)))
    rng = np.random.default_rng(5)
    d, h = tcfg.d_model, tcfg.n_heads
    x = rng.normal(size=(2, s, d)).astype(np.float32)
    st, jst = _pair(_state(rng, 2, h, d // h))
    cv = rng.normal(size=(2, tcfg.ssm_conv - 1, d)).astype(np.float32)
    out, new, new_cv = tssm.mlstm_block(block, torch.tensor(x), tcfg, tssm.MLSTMState(*st),
                                        torch.tensor(cv), chunk=8)
    jout, jnew, jcv = jssm.mlstm_block(jp, jnp.asarray(x), jcfg, jssm.MLSTMState(*jst),
                                       jnp.asarray(cv), chunk=8)
    _close(out, jout)
    _close(new_cv, jcv)
    for a, ja in zip(new, jnew):
        _close(a, ja)


@pytest.mark.parametrize("reshard", [False, True])
@pytest.mark.parametrize("start", ["zero", "carried"])
def test_slstm_block_matches_jax(start, reshard):
    """The per-timestep recurrence and the GELU FFN; with `slstm_reshard`
    the gate pre-activations are rounded to bf16 in both packages."""
    jcfg, tcfg = _cfgs(slstm_reshard=reshard)
    jp = jax.tree.map(np.asarray, jssm.init_slstm_block(jax.random.PRNGKey(6), jcfg))
    rng = np.random.default_rng(7)
    # gates of a trained size, so that the recurrence and the bf16 rounding count
    jp = dict(jp, r_gates=(0.3 * rng.normal(size=jp["r_gates"].shape)).astype(np.float32),
              b_gates=(0.5 * rng.normal(size=jp["b_gates"].shape)).astype(np.float32))
    block = tssm.SLSTMBlock(tcfg, generator=None, device=torch.device("cpu"))
    with torch.no_grad():
        for name, p in block.named_parameters():
            leaf = jp
            for key in name.split("."):
                leaf = leaf[key]
            p.copy_(torch.tensor(np.asarray(leaf, np.float32)))
    b, s, d, h = 2, 11, tcfg.d_model, tcfg.n_heads
    x = (3.0 * rng.normal(size=(b, s, d))).astype(np.float32)
    if start == "zero":
        st, jst = None, None
    else:
        hd = d // h
        arrays = [(0.5 * rng.normal(size=(b, h, hd))).astype(np.float32) for _ in range(4)]
        arrays[1] = np.abs(arrays[1]) + 0.5            # a normalizer is positive
        st, jst = _pair(arrays)
        st, jst = tssm.SLSTMState(*st), jssm.SLSTMState(*jst)
    out, new = tssm.slstm_block(block, torch.tensor(x), tcfg, st)
    jout, jnew = jssm.slstm_block(jp, jnp.asarray(x), jcfg, jst)
    _close(out, jout)
    for a, ja in zip(new, jnew):
        _close(a, ja)
    # the bf16 rounding of the gates is a different function
    other, _ = tssm.slstm_block(block, torch.tensor(x),
                                dataclasses.replace(tcfg, slstm_reshard=not reshard), st)
    assert not np.allclose(_np(other), _np(jout), rtol=1e-5, atol=1e-5)


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
    """The states against the JAX package's. With `ref32` (bf16 runs), the
    conv caches, which hold the blocks' raw bf16 inputs, are held by
    `_noise_close`: past the first group the two packages' bf16 values lie
    a few bf16 ulps apart (XLA's CPU lowering rounds each op of
    jax.nn.silu's 1 / (1 + e^-x) to bf16, F.silu rounds once), beyond 3e-2
    at an entry near 0. The fp32 recurrent states are held at tol."""
    for key in ("mlstm", "slstm"):
        for a, ja in zip(got[key], want[key]):
            assert tuple(a.shape) == tuple(ja.shape), key
            _close(a, ja, tol)
    assert tuple(got["conv"].shape) == tuple(want["conv"].shape)
    if ref32 is not None:
        _noise_close(got["conv"], want["conv"], ref32["conv"], "conv")
    else:
        _close(got["conv"], want["conv"], tol)


def _fp32_reference(jcfg, jparams, prompt):
    """The JAX package's fp32 prefill of `prompt` with the bf16 weights cast
    to fp32, and a function taking its states one decode step on."""
    f32 = dataclasses.replace(jcfg, dtype=jnp.float32, param_dtype=jnp.float32)
    model = jbuild_model(f32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    decode = jax.jit(model.decode_fn)

    def step(out, tok):
        cache, logits = decode(params, out["cache"], tok)
        return {"cache": cache, "logits": logits}

    return jax.jit(model.prefill_fn)(params, prompt), step


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_reduced_xlstm_loss_prefill_decode_match_jax(dtype, monkeypatch):
    """loss_fn (S = 70: one whole mLSTM chunk of 64 and a padded one),
    prefill of 40 tokens and 3 decode steps against the JAX package's
    jitted functions, states included; no kernel launches."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models(dtype)
    tol = F32 if dtype == "fp32" else BF16
    calls = []
    for name in ("flash_attention", "flash_attention_bwd"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, **k: calls.append(1) or _r(*a, **k))
    batch = TokenStream(tcfg, 2, 70, seed=3)(0)
    with torch.no_grad():
        loss, metrics = tmodel.loss_fn(tparams, batch)
    jloss, jmetrics = jax.jit(jmodel.loss_fn)(jparams, batch)
    _close(loss, jloss, tol)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"])

    prompt = {"tokens": batch["tokens"][:, :40]}
    out = tmodel.prefill_fn(tparams, prompt)
    jout = jax.jit(jmodel.prefill_fn)(jparams, prompt)
    _close(out["logits"], jout["logits"], tol)
    # the JAX fp32 forward of the same (bf16) weights: the bf16 caches' yardstick
    ref, ref_decode = _fp32_reference(jcfg, jparams, prompt) if dtype == "bf16" else (None, None)
    _states_close(out["cache"], jout["cache"], tol, ref and ref["cache"])
    cache, jcache = out["cache"], jout["cache"]
    jdecode = jax.jit(jmodel.decode_fn)
    for step in range(3):
        tok = {"tokens": batch["tokens"][:, 40 + step:41 + step]}
        cache, logits = tmodel.decode_fn(tparams, cache, tok)
        jcache, jlogits = jdecode(jparams, jcache, tok)
        _close(logits, jlogits, tol)
        if ref is not None:
            ref = ref_decode(ref, tok)
    _states_close(cache, jcache, tol, ref and ref["cache"])
    assert not calls


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_xlstm_cache_invariant(dtype):
    """prefill(t) against prefill(t[:-1]) + decode(t[-1]), on the port alone:
    the chunked mLSTM from zero against the chunked prefix and one
    sequential step."""
    _, tcfg, _, _, tmodel, tparams = _models(dtype, seed=1)
    tol = F32 if dtype == "fp32" else BF16
    toks = torch.as_tensor(TokenStream(tcfg, 2, 33, seed=4)(0)["tokens"])
    full = tmodel.prefill_fn(tparams, {"tokens": toks})
    short = tmodel.prefill_fn(tparams, {"tokens": toks[:, :-1]})
    cache, dec = tmodel.decode_fn(tparams, short["cache"], {"tokens": toks[:, -1:]})
    _close(dec, full["logits"], tol)
    _states_close(cache, full["cache"], tol)


def test_xlstm_decode_consumes_and_returns_its_states():
    _, tcfg, _, _, tmodel, tparams = _models()
    out = tmodel.prefill_fn(tparams, {"tokens": np.zeros((2, 5), np.int32)})
    c0 = out["cache"]["mlstm"][0]
    before = c0.clone()
    cache, _ = tmodel.decode_fn(tparams, out["cache"], {"tokens": np.ones((2, 1), np.int32)})
    assert cache["mlstm"][0] is c0 and not torch.equal(c0, before)
    assert tuple(out["logits"].shape) == (2, tcfg.vocab_size)
    assert out["logits"].untyped_storage().nbytes() == out["logits"].numel() * 4


def test_xlstm_chunk_is_fixed_at_64():
    """xlstm_forward runs the mLSTM at chunk 64 whatever cfg.ssm_chunk says,
    as the JAX package's does."""
    _, tcfg, _, _, tmodel, tparams = _models()
    batch = TokenStream(tcfg, 1, 80, seed=6)(0)
    with torch.no_grad():
        a, _ = tmodel.loss_fn(tparams, batch)
        b, _ = XLSTMModel(dataclasses.replace(tcfg, ssm_chunk=16), device="cpu").loss_fn(
            tparams, batch)
    assert float(a) == float(b)
    assert tssm.MLSTM_CHUNK == 64


def test_xlstm_params_from_numpy_refuses_missing_and_extra_leaves():
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    params = params_from_numpy(tree, tcfg, device="cpu")
    names = dict(params.named_parameters())
    assert {"mlstm.1.0.w_up", "slstm.1.r_gates", "mlstm.0.0.ln.scale",
            "ln_final.scale", "embed"} <= set(names)
    # the gates stay fp32 where the rest is the config's dtype
    bf = params_from_numpy(tree, dataclasses.replace(tcfg, param_dtype=torch.bfloat16,
                                                     dtype=torch.bfloat16), device="cpu")
    for name, p in bf.named_parameters():
        gate = name.split(".")[-1] in ("w_if", "b_if", "w_gates", "r_gates", "b_gates")
        assert p.dtype == (torch.float32 if gate else torch.bfloat16), name
    np.testing.assert_array_equal(_np(names["mlstm.1.0.wq"]), tree["mlstm"]["wq"][1, 0])
    with pytest.raises(ValueError, match="leaves with no parameter"):
        params_from_numpy(dict(tree, extra=np.zeros((3,), np.float32)), tcfg, device="cpu")
    slstm = {k: v for k, v in tree["slstm"].items() if k != "b_gates"}
    with pytest.raises(KeyError, match="b_gates"):
        params_from_numpy(dict(tree, slstm=slstm), tcfg, device="cpu")
    # a third group stacked in the tree is a slice too many
    grown = jax.tree.map(lambda a: np.concatenate([a, a[:1]]), tree["slstm"])
    with pytest.raises(ValueError, match="slstm/"):
        params_from_numpy(dict(tree, slstm=grown), tcfg, device="cpu")


def test_build_model_gives_the_xlstm():
    cfg = reduced(get_config("xlstm-350m"))
    assert isinstance(build_model(cfg, device="cpu"), XLSTMModel)
    model = build_model(get_config("xlstm-350m"), device="cpu")
    assert isinstance(model, XLSTMModel) and model.cfg.n_layers == 24


# ---------------------------------------------------------------------------
# remat: each mLSTM block recomputed in the backward
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


def test_xlstm_remat_recomputes_each_mlstm_block(monkeypatch):
    """Under grad with cfg.remat each mLSTM block runs under
    torch.utils.checkpoint, as the JAX package's jax.checkpoint(m_body):
    the gradients are those without remat bit for bit, autograd keeps
    fewer bytes, and each block's forward runs a second time in the
    backward. The sLSTM stays outside the checkpoint (run once)."""
    _, tcfg, _, _, _, tparams = _models()
    batch = TokenStream(tcfg, 2, 70, seed=3)(0)
    calls = {"mlstm": 0, "slstm": 0}
    for name in calls:
        real = getattr(tssm, f"{name}_block")

        def counted(*a, _r=real, _n=name, **k):
            calls[_n] += 1
            return _r(*a, **k)
        monkeypatch.setattr(tssm, f"{name}_block", counted)
    n_groups, n_m = tssm.xlstm_groups(tcfg)
    runs = {}
    for remat in (False, True):
        calls.update(mlstm=0, slstm=0)
        model = XLSTMModel(dataclasses.replace(tcfg, remat=remat), device="cpu")
        runs[remat] = _grads_and_saved_bytes(model, tparams, batch) + (dict(calls),)
    (l0, g0, b0, c0), (l1, g1, b1, c1) = runs[False], runs[True]
    assert l0 == l1
    for name, g in g0.items():
        assert torch.equal(g, g1[name]), name
    assert b1 < b0, (b1, b0)
    assert c0 == {"mlstm": n_groups * n_m, "slstm": n_groups}
    assert c1 == {"mlstm": 2 * n_groups * n_m, "slstm": n_groups}
    # without grad there is nothing to recompute: remat changes nothing
    with torch.no_grad():
        a, _ = XLSTMModel(dataclasses.replace(tcfg, remat=True), device="cpu").loss_fn(
            tparams, batch)
    assert float(a) == l0
