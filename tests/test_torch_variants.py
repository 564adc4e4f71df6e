"""The `opt` variant on the port against the JAX package on the CPU:
`configs/variants.py` (`optimized`, `VARIANTS`, `apply_variant`) field for
field, the direct attention path's bf16 probabilities (`attn_probs_bf16`),
and reduced models' losses under the overlay (the grouped MoE dispatch and
the hybrid's SSD at chunk 64 with its decay folded). The grouped dispatch
is held bit for bit in tests/test_torch_moe.py, the remat policies in
tests/test_torch_train.py.

Tolerances, and why:
  * `multi_head_attention` with bf16 probabilities, fp32 activations:
    2^-8 of the output's largest magnitude (one bf16 rounding of each
    probability and of v). Both packages round the same fp32 softmax to
    bf16; XLA's exp and torch's differ in the last fp32 bit, which moves a
    probability by a bf16 ulp only where it lies on a rounding midpoint.
    The readings are about 1e-7 of it; rounding the probabilities at all
    moves the output by more than 1e-3 of it, which the test also sees.
  * reduced models' losses in fp32 under `opt`: rtol 1e-4, the reduced
    models' fp32 tolerance (tests/test_torch_lm.py).
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
from repro.configs import variants as jvariants  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.api import EncDecModel as JEncDecModel  # noqa: E402
from repro_torch.configs import REGISTRY, VARIANTS, apply_variant, get_config, reduced  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.models import EncDecModel, build_model, params_from_numpy  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _same_fields(tcfg, jcfg):
    for f in dataclasses.fields(tcfg):
        mine, theirs = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if isinstance(mine, torch.dtype):
            assert DTYPE_NAMES[mine] == jnp.dtype(theirs).name, f.name
        else:
            assert mine == theirs, (f.name, mine, theirs)


@pytest.mark.parametrize("variant", ["base", "opt"])
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_apply_variant_matches_jax_field_for_field(arch, variant):
    """apply_variant on every ported config, at full width and reduced,
    against the JAX package's: every field of the port's ModelConfig,
    attn_probs_bf16 among them."""
    assert set(VARIANTS) == set(jvariants.VARIANTS)
    assert "attn_probs_bf16" in {f.name for f in dataclasses.fields(tl.ModelConfig)}
    _same_fields(apply_variant(get_config(arch), variant),
                 jvariants.apply_variant(jget_config(arch), variant))
    _same_fields(apply_variant(reduced(get_config(arch)), variant),
                 jvariants.apply_variant(jreduced(jget_config(arch)), variant))


@pytest.mark.parametrize("causal,window,cap", [(True, 0, 0.0), (True, 8, 50.0),
                                               (False, 0, 0.0)])
def test_bf16_probabilities_on_the_direct_path_match_jax(causal, window, cap):
    """multi_head_attention(probs_bf16=True) on fp32 activations (GQA,
    S_q 24 over S_k 24 or 20) against the JAX direct path with the same
    flag: the probabilities and v rounded to bf16 before P V, summed in
    fp32; without the flag the output differs."""
    rng = np.random.default_rng(int(causal) + window)
    sk = 24 if causal else 20
    q = rng.normal(size=(2, 24, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, sk, 2, 32)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    got = tl.multi_head_attention(*(torch.tensor(x) for x in (q, k, v)), probs_bf16=True, **kw)
    plain = tl.multi_head_attention(*(torch.tensor(x) for x in (q, k, v)), **kw)
    want = jl.multi_head_attention(*(jnp.asarray(x) for x in (q, k, v)), probs_bf16=True, **kw)
    assert got.dtype == torch.float32
    top = float(np.abs(_np(want)).max())
    assert float(np.abs(_np(got) - _np(want)).max()) <= 2.0 ** -8 * top
    assert float(np.abs(_np(plain) - _np(want)).max()) > 1e-3 * top


def _jmodel(jcfg):
    if jcfg.family == "audio":       # 256 decoder positions, as the port's tests take
        return JEncDecModel(jcfg, max_dec_len=256)
    return jbuild_model(jcfg)


def _model(tcfg):
    if tcfg.family == "audio":
        return EncDecModel(tcfg, device="cpu", max_dec_len=256)
    return build_model(tcfg, device="cpu")


@pytest.mark.parametrize("arch,seq", [("gemma2-2b", 32), ("granite-moe-3b-a800m", 32),
                                      ("zamba2-7b", 48), ("whisper-medium", 32)])
def test_opt_variant_losses_match_jax(arch, seq):
    """The reduced model's loss_fn in fp32 under apply_variant(.., "opt")
    against the JAX package's under its own: the direct path's bf16
    probabilities, the MoE's grouped dispatch, the hybrid's SSD at chunk 64
    with its decay folded; the overlay moves the loss."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), dtype=jnp.float32,
                               param_dtype=jnp.float32)
    tcfg = dataclasses.replace(reduced(get_config(arch)), dtype=torch.float32,
                               param_dtype=torch.float32)
    jopt, topt = jvariants.apply_variant(jcfg, "opt"), apply_variant(tcfg, "opt")
    jparams = _jmodel(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    batch = TokenStream(tcfg, 2, seq, seed=5)(0)
    with torch.no_grad():
        loss = float(_model(topt).loss_fn(tparams, batch)[0])
        base = float(_model(tcfg).loss_fn(tparams, batch)[0])
    jloss = float(jax.jit(_jmodel(jopt).loss_fn)(jparams, batch)[0])
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    assert loss != base
