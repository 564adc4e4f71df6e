"""The port's MoE decoder (granite-moe-3b-a800m) against the JAX package on
the CPU.

`moe_block` is the capacity-bounded, sort-based top-k dispatch of
`repro/models/layers.py::moe_block`. It is held at `reduced` (8 experts,
top 2, capacity factor 8: no replica is dropped) and again at
`capacity_factor=1.0`, where replicas are dropped. Inputs and parameters
come from numpy under a seed; the routers are drawn with no ties.

Tolerances, and why:
  * bit for bit, in fp32 and in bf16, where both packages compute the
    softmax and SiLU with the same numpy functions and the router's
    products are exact (inputs on a grid of 1/4, router weights on a grid
    of 1/4096): the routing, the capacity, the dispatch and the combine
    (each token's contributions added in bf16 one at a time, in ascending
    expert order) give the JAX package's bits.
  * with each package's own softmax and SiLU: fp32 within 1e-5 of the
    output's largest magnitude, bf16 within 2^-6 of it (a few bf16 ulps).
    XLA's exp and logistic and torch's differ in the last bit, and the
    router's product of 8 outputs is summed in another order (1.1e-6
    apart); a bf16 expert output one ulp off moves the sum by an ulp.
  * aux: rtol 1e-6; the mean over tokens is an fp32 sum in another order.
  * the grouped dispatch (`moe_group_dispatch`, each sequence its own
    group) against `_moe_grouped` at the same tolerances: bit for bit with
    the shared functions, within the limits above with each package's own;
    at one sequence it is the global dispatch bit for bit.
  * gradients in fp32: rtol 1e-4 and an atol of 1e-5 of each gradient's
    largest magnitude (tests/test_torch_train.py's).
  * the reduced decoder: rtol/atol 1e-4 in fp32 and 3e-2 in bf16
    (tests/test_torch_lm.py's).
"""
import dataclasses

import ml_dtypes
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
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import DecoderModel, params_from_numpy  # noqa: E402
from repro_torch.models import layers as tl, transformer as tt  # noqa: E402

NAME = "granite-moe-3b-a800m"
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
CPU = torch.device("cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(dtype="fp32", **upd):
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jreduced(jget_config(NAME)), dtype=jdt, param_dtype=jdt, **upd)
    tcfg = dataclasses.replace(reduced(get_config(NAME)), dtype=tdt, param_dtype=tdt, **upd)
    return jcfg, tcfg


def _moe(dtype, cf, *, dyadic=False, seed=1, **upd):
    """A JAX MoE parameter tree (numpy), the port's MoE holding the same
    values, inputs x (2, 24, d) and both configs. `dyadic`: inputs on a
    grid of 1/4 and router weights on a grid of 1/4096 within +-1/8, so
    that every product and sum of the router is exact in fp32 (at most 18
    significant bits)."""
    jcfg, tcfg = _cfgs(dtype, capacity_factor=cf, **upd)
    jp = jax.tree.map(np.asarray, jl.init_moe(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    if dyadic:
        jp["router"] = (rng.integers(-512, 513, size=jp["router"].shape)
                        / 4096).astype(np.float32)
        x = (rng.integers(-4, 5, size=(2, 24, tcfg.d_model)) / 4).astype(np.float32)
    else:
        x = rng.normal(size=(2, 24, tcfg.d_model)).astype(np.float32)
    moe = tl.init_moe(tcfg, generator=None, device=CPU)
    with torch.no_grad():
        for n, p in moe.named_parameters():
            p.copy_(torch.tensor(np.asarray(jp[n], np.float32)).to(p.dtype))
    assert moe.router.dtype == torch.float32 and jp["router"].dtype == np.float32
    return jcfg, tcfg, jp, moe, x


def _no_ties(moe, x, tcfg):
    probs = torch.softmax(torch.tensor(x).reshape(-1, tcfg.d_model).float() @ moe.router, -1)
    top = torch.sort(probs, dim=-1, descending=True).values
    assert bool((top[:, :-1] > top[:, 1:]).all()), "a router with tied probabilities"


def _np_softmax(x, axis=-1):
    x = np.asarray(x, np.float32)
    e = np.exp(x - x.max(axis, keepdims=True))
    return e / e.sum(axis, keepdims=True, dtype=np.float32)


def _np_silu(x):
    """SiLU in fp32 numpy, rounded to x's dtype (bf16 through ml_dtypes)."""
    f = np.asarray(x, np.float32)
    return (f / (np.float32(1) + np.exp(-f))).astype(np.asarray(x).dtype)


@pytest.fixture
def shared_elementwise(monkeypatch):
    """Both packages' softmax and SiLU computed by the same numpy
    functions (the JAX block runs eagerly, so it hands numpy concrete
    arrays)."""
    monkeypatch.setattr(jax.nn, "softmax",
                        lambda x, axis=-1: jnp.asarray(_np_softmax(np.asarray(x), axis)))
    monkeypatch.setattr(jax.nn, "silu", lambda x: jnp.asarray(_np_silu(np.asarray(x))))
    monkeypatch.setattr(torch, "softmax",
                        lambda x, dim=-1: torch.from_numpy(_np_softmax(x.detach().numpy(), dim)))

    def act(cfg, x):
        if x.dtype == torch.bfloat16:
            a = x.detach().float().numpy().astype(ml_dtypes.bfloat16)
            return torch.from_numpy(_np_silu(a).astype(np.float32)).bfloat16()
        return torch.from_numpy(_np_silu(x.detach().numpy()))

    monkeypatch.setattr(tl, "_act", act)


def _dropped(moe, x, tcfg):
    route = tl.moe_route(moe, torch.tensor(x).to(tcfg.dtype).reshape(-1, tcfg.d_model), tcfg)
    return int((route.counts - route.cap).clamp(min=0).sum()), route


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("cf", [8.0, 1.0])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_moe_block_bit_for_bit(dtype, cf, k, shared_elementwise):
    """With the same elementwise functions on both sides and an exact
    router, out is the JAX package's bits, dropped replicas included, at
    reduced's top 2 and at top 4 (aux at rtol 1e-6: the mean over tokens
    is an fp32 sum in another order). At top 4 in bf16 the same
    contributions added in descending expert order are not, so the test
    sees the order of the combine (two terms add the same either way)."""
    jcfg, tcfg, jp, moe, x = _moe(dtype, cf, dyadic=True, n_experts_active=k)
    _no_ties(moe, x, tcfg)
    dropped, route = _dropped(moe, x, tcfg)
    assert (dropped > 0) == (cf == 1.0) and route.cap == 48 * k // 8 * int(cf)
    xt = torch.tensor(x).to(tcfg.dtype)
    with torch.no_grad():
        out, aux = tl.moe_block(moe, xt, tcfg)
    jout, jaux = jl.moe_block(jp, jnp.asarray(x, jcfg.dtype), jcfg)
    assert out.dtype == tcfg.dtype
    np.testing.assert_array_equal(_np(out), _np(jout))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    if dtype == "bf16" and k > 2:
        real = tl.moe_combine

        def reversed_order(y, r, cfg):
            flip = torch.arange(r.top_e.shape[1] - 1, -1, -1)
            t, k = r.top_e.shape
            perm = (torch.arange(t)[:, None] * k + flip).reshape(-1)
            return real(y, r._replace(top_e=r.top_e[:, flip], top_w=r.top_w[:, flip],
                                      rep_slot=r.rep_slot[perm], rep_keep=r.rep_keep[perm]),
                        cfg)

        tl.moe_combine = reversed_order
        try:
            with torch.no_grad():
                wrong, _ = tl.moe_block(moe, xt, tcfg)
        finally:
            tl.moe_combine = real
        assert not np.array_equal(_np(wrong), _np(jout))


@pytest.mark.parametrize("cf", [8.0, 1.0])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_moe_block_matches_jax(dtype, cf):
    """Each package's own softmax and SiLU, N(0, 1) inputs: out within
    1e-5 (fp32) or 2^-6 (bf16) of its largest magnitude, aux at rtol 1e-6,
    and the routing's integers equal."""
    jcfg, tcfg, jp, moe, x = _moe(dtype, cf)
    _no_ties(moe, x, tcfg)
    with torch.no_grad():
        out, aux = tl.moe_block(moe, torch.tensor(x).to(tcfg.dtype), tcfg)
    jout, jaux = jl.moe_block(jp, jnp.asarray(x, jcfg.dtype), jcfg)
    frac = 1e-5 if dtype == "fp32" else 2.0 ** -6
    top = float(np.abs(_np(jout)).max())
    assert float(np.abs(_np(out) - _np(jout)).max()) <= frac * top
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # the routing: each token's experts, each expert's count, the capacity
    t, k = 48, jcfg.n_experts_active
    xf = jnp.asarray(x, jcfg.dtype).reshape(t, -1)
    _, jtop_e = jax.lax.top_k(jax.nn.softmax(xf.astype(jnp.float32) @ jp["router"], -1), k)
    _, route = _dropped(moe, x, tcfg)
    np.testing.assert_array_equal(route.top_e.numpy(), np.sort(np.asarray(jtop_e), axis=1))
    np.testing.assert_array_equal(route.counts.numpy()[:jcfg.n_experts],
                                  np.bincount(np.asarray(jtop_e).ravel(),
                                              minlength=jcfg.n_experts))


@pytest.mark.parametrize("cf,pad", [(8.0, 8), (1.0, 12)])
def test_moe_gradients_match_jax(cf, pad):
    """The gradients of sum(out * c) + aux with respect to the input and
    every MoE parameter, fp32, against jax.grad through moe_block; with 4
    pad experts in the second case, whose gradients are 0."""
    jcfg, tcfg, jp, moe, x = _moe("fp32", cf, n_experts_pad=pad)
    c = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def jloss(params, xx):
        out, aux = jl.moe_block(params, xx, jcfg)
        return jnp.sum(out * c) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in jp.items()},
                                               jnp.asarray(x))
    xt = torch.tensor(x).requires_grad_()
    out, aux = tl.moe_block(moe, xt, tcfg)
    ((out * torch.tensor(c)).sum() + aux).backward()
    for got, want, name in [(xt.grad, jgx, "x")] + [
            (p.grad, jgp[n], n) for n, p in moe.named_parameters()]:
        want = _np(want)
        atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=atol, err_msg=name)
    # the pad experts are never routed to
    for p in (moe.w_gate, moe.w_up, moe.w_down):
        assert p.shape[0] == pad and not p.grad[jcfg.n_experts:].any()


def test_moe_backward_adds_into_no_row_by_index():
    """No node of the MoE's autograd graph has a backward that adds into
    rows by index (index_select's, indexing's and gather's backwards are
    index_add_, accumulating index_put_ and scatter_add: atomic on the
    card); the routes' backwards are gathers."""
    _, tcfg, _, moe, x = _moe("fp32", 1.0)
    out, aux = tl.moe_block(moe, torch.tensor(x).requires_grad_(), tcfg)
    seen, stack, names = set(), [out.grad_fn, aux.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    assert "_RouteBackward" in names
    adders = {"IndexSelectBackward0", "IndexBackward0", "IndexPutBackward0",
              "GatherBackward0", "TakeAlongDimBackward0", "RepeatInterleaveBackward0",
              "IndexAddBackward0", "ScatterAddBackward0"}
    assert not names & adders, sorted(names & adders)


def test_top_k_takes_the_lower_index_first_among_ties():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.1],
                      [0.25, 0.25, 0.25, 0.25, 0.0],
                      [0.0, 0.5, 0.0, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3):
        v, i = tl.top_k(torch.tensor(probs), k)
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# the grouped dispatch (moe_group_dispatch) and moe_ep_shard_map
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cf", [8.0, 1.0])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_moe_grouped_dispatch_bit_for_bit(dtype, cf, shared_elementwise):
    """moe_group_dispatch: each of the 2 sequences is its own dispatch
    group (routing, sort and capacity per sequence, cap = ceil(24 k / 8
    cf)), and with the same elementwise functions and an exact router out
    is `_moe_grouped`'s bits, dropped replicas included (aux at rtol
    1e-6, as above). At capacity factor 1 the global dispatch drops other
    replicas, so its output is not the grouped one's."""
    jcfg, tcfg, jp, moe, x = _moe(dtype, cf, dyadic=True, moe_group_dispatch=True)
    _no_ties(moe, x, tcfg)
    xt = torch.tensor(x).to(tcfg.dtype)
    route = tl.moe_route(moe, xt.reshape(-1, tcfg.d_model), tcfg, groups=2)
    assert route.cap == max(1, -(-24 * 2 * int(cf) // 8)) and route.counts.shape == (16,)
    with torch.no_grad():
        out, aux = tl.moe_block(moe, xt, tcfg)
        glob, _ = tl.moe_block(moe, xt, dataclasses.replace(tcfg, moe_group_dispatch=False))
    jout, jaux = jl._moe_grouped(jp, jnp.asarray(x, jcfg.dtype), jcfg)
    np.testing.assert_array_equal(_np(out), _np(jout))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert (cf == 8.0) == np.array_equal(_np(glob), _np(out))


@pytest.mark.parametrize("cf", [8.0, 1.0])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_moe_grouped_dispatch_matches_jax(dtype, cf):
    """Each package's own softmax and SiLU: the grouped dispatch within
    the tolerances of test_moe_block_matches_jax of JAX's moe_block under
    the same flag, and each group's counts its own."""
    jcfg, tcfg, jp, moe, x = _moe(dtype, cf, moe_group_dispatch=True)
    _no_ties(moe, x, tcfg)
    with torch.no_grad():
        out, aux = tl.moe_block(moe, torch.tensor(x).to(tcfg.dtype), tcfg)
    jout, jaux = jl.moe_block(jp, jnp.asarray(x, jcfg.dtype), jcfg)
    frac = 1e-5 if dtype == "fp32" else 2.0 ** -6
    assert float(np.abs(_np(out) - _np(jout)).max()) <= frac * float(np.abs(_np(jout)).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    k = jcfg.n_experts_active
    xf = jnp.asarray(x, jcfg.dtype).reshape(48, -1)
    _, jtop_e = jax.lax.top_k(jax.nn.softmax(xf.astype(jnp.float32) @ jp["router"], -1), k)
    route = tl.moe_route(moe, torch.tensor(x).to(tcfg.dtype).reshape(48, -1), tcfg, groups=2)
    per_group = np.stack([np.bincount(np.asarray(jtop_e)[24 * g:24 * (g + 1)].ravel(),
                                      minlength=8) for g in range(2)], axis=1)
    np.testing.assert_array_equal(route.counts.view(8, 2).numpy(), per_group)


def test_moe_dispatches_not_ported_raise():
    """Named when moe_group_dispatch and moe_ep_shard_map raised: both are
    ported now, so each flag alone runs and gives JAX's moe_block under the
    same flag (within test_moe_block_matches_jax's fp32 limit): the grouped
    dispatch, and the EP flag falling through to the global dispatch
    without a mesh."""
    for flag in ("moe_group_dispatch", "moe_ep_shard_map"):
        jcfg, tcfg, jp, moe, x = _moe("fp32", 1.0, **{flag: True})
        with torch.no_grad():
            out, _ = tl.moe_block(moe, torch.tensor(x), tcfg)
        jout, _ = jl.moe_block(jp, jnp.asarray(x), jcfg)
        top = float(np.abs(_np(jout)).max())
        assert float(np.abs(_np(out) - _np(jout)).max()) <= 1e-5 * top, flag


@pytest.mark.parametrize("group", [False, True])
def test_moe_ep_shard_map_without_a_mesh_falls_through(group):
    """moe_ep_shard_map takes its shard_map only under an active mesh,
    which the port never has: with it set the output is that of the flags
    without it, as the JAX package's moe_block gives it without a mesh
    (global dispatch alone, grouped with moe_group_dispatch)."""
    jcfg, tcfg, jp, moe, x = _moe("fp32", 1.0, moe_ep_shard_map=True, moe_group_dispatch=group)
    xt = torch.tensor(x)
    with torch.no_grad():
        out, _ = tl.moe_block(moe, xt, tcfg)
        plain, _ = tl.moe_block(moe, xt, dataclasses.replace(tcfg, moe_ep_shard_map=False))
    assert torch.equal(out, plain)
    jout, _ = jl.moe_block(jp, jnp.asarray(x), jcfg)
    assert float(np.abs(_np(out) - _np(jout)).max()) <= 1e-5 * float(np.abs(_np(jout)).max())


def test_moe_grouped_dispatch_at_one_sequence_is_the_global_dispatch():
    """At B = 1 the one group is the batch: the same sort and capacity, so
    the grouped dispatch gives the global one's output and gradients bit
    for bit (chip_smoke.py holds the same at full width on the card). At
    S k < 4 E both take the global dispatch, as in JAX."""
    _, tcfg, _, moe, x = _moe("bf16", 1.0)
    outs = []
    for group in (False, True):
        xt = torch.tensor(x[:1]).bfloat16().requires_grad_()
        for p in moe.parameters():
            p.grad = None
        out, aux = tl.moe_block(moe, xt, dataclasses.replace(tcfg, moe_group_dispatch=group))
        (out.float().square().sum() + aux).backward()
        outs.append([out.detach(), aux.detach(), xt.grad] + [p.grad for p in moe.parameters()])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    short = torch.tensor(x[:, :15]).bfloat16()          # 15 x 2 < 4 x 8
    with torch.no_grad():
        a, _ = tl.moe_block(moe, short, dataclasses.replace(tcfg, moe_group_dispatch=True))
        b, _ = tl.moe_block(moe, short, tcfg)
    assert torch.equal(a, b)


def test_moe_grouped_gradients_match_jax():
    """The grouped dispatch's gradients of sum(out * c) + aux, fp32, with
    dropped replicas, against jax.grad through moe_block under the same
    flag, at test_moe_gradients_match_jax's tolerances; its backward adds
    into no row by index either."""
    jcfg, tcfg, jp, moe, x = _moe("fp32", 1.0, moe_group_dispatch=True)
    c = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def jloss(params, xx):
        out, aux = jl.moe_block(params, xx, jcfg)
        return jnp.sum(out * c) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in jp.items()},
                                               jnp.asarray(x))
    xt = torch.tensor(x).requires_grad_()
    out, aux = tl.moe_block(moe, xt, tcfg)
    loss = (out * torch.tensor(c)).sum() + aux
    names, stack, seen = set(), [loss.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    assert not names & {"IndexBackward0", "IndexPutBackward0", "IndexAddBackward0",
                        "ScatterAddBackward0", "IndexSelectBackward0"}
    loss.backward()
    for got, want, name in [(xt.grad, jgx, "x")] + [
            (p.grad, jgp[n], n) for n, p in moe.named_parameters()]:
        want = _np(want)
        atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# the reduced decoder
# ---------------------------------------------------------------------------
def _models(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jmodel, jparams, DecoderModel(tcfg, device="cpu"), tparams


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_reduced_granite_moe_loss_prefill_decode_match_jax(dtype, monkeypatch):
    """loss_fn (ce + 0.01 aux) with its aux, prefill and 3 decode steps
    against the JAX package's jitted functions, the flash wrapper in every
    layer of the loss, and the cache invariant."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models(dtype)
    assert tparams.layers[0].moe.router.dtype == torch.float32
    assert not hasattr(tparams.layers[0], "mlp")
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "fp32" else dict(rtol=3e-2, atol=3e-2)
    batch = TokenStream(tcfg, 2, 64, seed=3)(0)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        loss, metrics = tmodel.loss_fn(tparams, batch)
    assert len(calls) == tcfg.n_layers
    jloss, jmetrics = jax.jit(jmodel.loss_fn)(jparams, batch)
    np.testing.assert_allclose(float(loss), float(jloss), **tol)
    # in bf16 the router sees bf16 activations, whose rounding moves a few
    # tokens' choices between the packages: aux is a mean over them
    np.testing.assert_allclose(float(metrics["aux"]), float(jmetrics["aux"]),
                               **(dict(rtol=1e-5) if dtype == "fp32" else tol))
    np.testing.assert_allclose(float(metrics["ce"]), float(jmetrics["ce"]), **tol)
    assert float(metrics["aux"]) > 0.5 * tcfg.n_layers       # E sum(me ce) is about 1 a layer
    assert float(loss) == float(metrics["ce"] + 0.01 * metrics["aux"])

    prompt = {"tokens": batch["tokens"][:, :32]}
    out = tmodel.prefill_fn(tparams, prompt)
    jout = jax.jit(jmodel.prefill_fn)(jparams, prompt)
    np.testing.assert_allclose(_np(out["logits"]), _np(jout["logits"]), **tol)
    cache, jcache = out["cache"], jout["cache"]
    jdecode = jax.jit(jmodel.decode_fn)
    for step in range(3):
        tok = {"tokens": batch["tokens"][:, 32 + step:33 + step]}
        cache, logits = tmodel.decode_fn(tparams, cache, tok)
        jcache, jlogits = jdecode(jparams, jcache, tok)
        np.testing.assert_allclose(_np(logits), _np(jlogits), **tol)

    toks = torch.as_tensor(batch["tokens"][:, :33])
    full = tmodel.prefill_fn(tparams, {"tokens": toks})["logits"]
    short = tmodel.prefill_fn(tparams, {"tokens": toks[:, :-1]})
    _, dec = tmodel.decode_fn(tparams, short["cache"], {"tokens": toks[:, -1:]})
    np.testing.assert_allclose(_np(dec), _np(full), **tol)


def test_reduced_granite_moe_gradients_match_jax():
    """jax.grad(model.loss_fn), aux term included, against the port's
    loss.backward() in fp32 for every parameter, through the flash path."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models("fp32")
    batch = TokenStream(tcfg, 2, 64, seed=4)(0)
    loss, _ = tmodel.loss_fn(tparams, batch)
    loss.backward()
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
        jparams, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for n, p in tparams.named_parameters():
        want = _np(tt.param_leaf(jgrads, n)[1])
        atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(_np(p.grad), want, rtol=1e-4, atol=atol, err_msg=n)


def test_remat_keeps_the_aux_loss():
    """Under remat each layer's aux comes out of the checkpoint: the loss
    and the gradients are those without remat, bit for bit."""
    _, tcfg, _, _, _, tparams = _models("fp32")
    batch = TokenStream(tcfg, 2, 64, seed=6)(0)
    got = []
    for remat in (False, True):
        model = DecoderModel(dataclasses.replace(tcfg, remat=remat), device="cpu")
        for p in tparams.parameters():
            p.grad = None
        loss, metrics = model.loss_fn(tparams, batch)
        loss.backward()
        got.append((float(loss.detach()), float(metrics["aux"]),
                    [p.grad.clone() for p in tparams.parameters()]))
    assert got[0][:2] == got[1][:2]
    assert all(torch.equal(a, b) for a, b in zip(got[0][2], got[1][2]))
