"""The port's int8 gradient compression (`repro_torch/optim/compress.py`)
against `repro.optim.compress` on the CPU, bit for bit.

The JAX `compressed_psum` reduces over a mesh axis; here it runs under
`jax.vmap(..., axis_name="pod")` on one CPU device, which gives the same
collectives (`pmax`, `psum`) over the vmapped axis. The port holds the P
shards' trees in one process and takes them as a list. Every operation is
the same fp32 or integer one on both sides (max, division by 127, a
half-to-even round, an int32 sum, a product), so the test asks for equal
bits, over two rounds that carry the error. The JAX function runs
eagerly (without jit), each operation rounded on its own as its source
writes it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest-xdist runs several workers on the same cores,
# and torch's default thread count each would oversubscribe them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import compress as jc  # noqa: E402
from repro_torch.optim import compress as tc  # noqa: E402

P = 4


def _grads(seed):
    """P shards of a tree whose tensors differ in scale by 10^4 (the small
    one's payload rounds many values to 0 and halves to even)."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(P, 64, 32)).astype(np.float32),
            "b": (rng.normal(size=(P, 7)) * 1e-4).astype(np.float32),
            "h": np.round(rng.normal(size=(P, 5, 3)) * 4).astype(np.float32) / 8}


def test_compressed_psum_matches_jax_bit_for_bit_over_two_rounds():
    names = ("w", "b", "h")

    def shard(*args):
        g = dict(zip(names, args[:3]))
        e = dict(zip(names, args[3:]))
        out, st = jc.compressed_psum(g, jc.CompressState(error=e), "pod")
        return tuple(out[n] for n in names) + tuple(st.error[n] for n in names)

    # eager, op by op: under jit XLA's CPU code fuses the residual's
    # gf - q scale into one multiply-add, an fp32 ulp from the two
    # rounded operations that the JAX source (and the port) write
    jstep = jax.vmap(shard, axis_name="pod")
    jerr = {n: np.zeros_like(a) for n, a in _grads(0).items()}
    states = [tc.compress_init({n: torch.zeros(a.shape[1:]) for n, a in _grads(0).items()})
              for _ in range(P)]
    for rnd in range(2):
        g = _grads(rnd)
        res = jstep(*(g[n] for n in names), *(jerr[n] for n in names))
        jsum = dict(zip(names, res[:3]))
        jerr = {n: np.asarray(e) for n, e in zip(names, res[3:])}
        sums, states = tc.compressed_psum(
            [{n: torch.tensor(g[n][p]) for n in names} for p in range(P)], states)
        for p in range(P):
            for n in names:
                np.testing.assert_array_equal(sums[p][n].numpy(), np.asarray(jsum[n])[p])
                np.testing.assert_array_equal(states[p].error[n].numpy(), jerr[n][p])
        # error feedback: the sum and the carried residuals are the input
        total = sum(g["w"][p].astype(np.float64) for p in range(P))
        back = sums[0]["w"].double() + sum(s.error["w"].double() for s in states)
        assert rnd or np.abs(back.numpy() - total).max() < 1e-4


def test_int8_compress_and_decompress_match_jax():
    rng = np.random.default_rng(3)
    g = rng.normal(size=(128, 64)).astype(np.float32)
    e = (rng.normal(size=(128, 64)) * 1e-3).astype(np.float32)
    q, scale, err = tc.int8_compress(torch.tensor(g), torch.tensor(e))
    jq, jscale, jerr = jc.int8_compress(jnp.asarray(g), jnp.asarray(e))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    np.testing.assert_array_equal(tc.int8_decompress(q, scale).numpy(),
                                  np.asarray(jc.int8_decompress(jq, jscale)))
    assert float(err.abs().max()) <= float(scale) / 2 + 1e-6


def test_compress_init_and_mismatched_trees():
    params = torch.nn.Linear(3, 2)
    st = tc.compress_init(params)
    assert set(st.error) == {"weight", "bias"}
    assert all(t.dtype == torch.float32 and not t.any() for t in st.error.values())
    g = {"weight": torch.ones(2, 3), "bias": torch.ones(2)}
    with pytest.raises(ValueError, match="named"):
        tc.compressed_psum([g, {"weight": torch.ones(2, 3)}], [st, st])
