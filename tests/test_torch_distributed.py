"""The port's distributed sampler against the JAX package's, on the CPU.

`repro_torch.core.partition` against `repro.core.partition` (bit-equal
plans), and `repro_torch.core.distributed.DistributedBPMF` against
`repro.core.distributed.DistributedBPMF` at P = 4 item shards: one block's
statistics, one sweep in every exchange mode and stats engine, a 3-sweep
ring chain; then the port against itself (the async sweep's fresh v bit for
bit ring's, the stale chain's RMSE beside ring's), its ring exchange, a ring
planted to forward the wrong way, and the launcher.

The JAX side runs once, in a subprocess that forces 4 host devices (jax
fixes the device count when it starts, as tests/test_distributed.py
notes), and writes its plans' states, its replayed noise and its sweeps
to an .npz. The noise is the reference's own: `jax.random` draws taken
under the key splits of `make_sweep` (`split(state.key, 5)`), the per-item
z from `_per_item_noise` over every global id and the Normal-Wishart draws
as `repro.core.hyper.sample_normal_wishart` takes them, handed to the port
as a SweepNoise in global id order.

Data: the reference test's, `synthetic_lowrank(300, 200, k_true=8,
nnz=9000, noise=0.3, seed=3)` split 0.1 with seed 4, K = 16, alpha 11.0,
`width="auto"` (multi-row segments in most blocks).

Tolerances, and why:
  * plans: equal, array by array, dtypes too.
  * one block, one sweep, the chain's u, v and hyper lam: rtol 1e-4,
    atol 1e-3, the port's half-sweep tolerance (tests/test_torch_gibbs.py):
    fp32 statistics and Cholesky solves in another library's order.
  * the chain's RMSE: rel 1e-5, as the single-device chain.
  * async against ring: the first sweep's fresh v equal bit for bit (the
    reference's own gate, tests/test_distributed.py); RMSE within 0.05
    after 20 sweeps (its gate at p = 4).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest-xdist runs several workers on the same cores,
# and torch's default thread count each would oversubscribe them
torch.set_num_threads(1)

from repro.core import partition as jp  # noqa: E402
from repro.data import chembl_like, synthetic_lowrank, train_test_split  # noqa: E402
from repro_torch.core import distributed as td  # noqa: E402
from repro_torch.core import exchange  # noqa: E402
from repro_torch.core import partition as tp  # noqa: E402
from repro_torch.core.gibbs import SweepNoise  # noqa: E402
from repro_torch.core.hyper import WishartNoise  # noqa: E402
from repro_torch.data import SparseRatings  # noqa: E402
from repro_torch.launch import train as bpmf_train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
K, ALPHA, SEED, P = 16, 11.0, 7, 4
TOL = dict(rtol=1e-4, atol=1e-3)
MODES = ("ring", "allgather", "async")
ENGINES = ("einsum", "fused")
CPU4 = [torch.device("cpu")] * P

JAX_SIDE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.core import distributed as jd
from repro.data import synthetic_lowrank, train_test_split

K, ALPHA, SEED = {K}, {ALPHA}, {SEED}
ratings, _, _ = synthetic_lowrank(300, 200, k_true=8, nnz=9000, noise=0.3, seed=3)
train, test = train_test_split(ratings, 0.1, seed=4)
m, n = train.shape
out = {{}}


def nw_noise(key, rows):
    # the draws sample_normal_wishart(key, ...) takes for `rows` factor rows
    kw, km = jax.random.split(key)
    kn, kc = jax.random.split(kw)
    dfs = (jnp.asarray(float(K), jnp.float32) + jnp.asarray(rows, jnp.float32)
           - jnp.arange(K, dtype=jnp.float32))
    return (2.0 * jax.random.gamma(kc, dfs / 2.0, dtype=jnp.float32),
            jax.random.normal(kn, (K, K), jnp.float32),
            jax.random.normal(km, (K,), jnp.float32))


def noise(key, tag):
    # one sweep's draws under make_sweep's split, z in global id order
    key, k_hv, k_v, k_hu, k_u = jax.random.split(key, 5)
    for side, kh, kz, rows in (("v", k_hv, k_v, n), ("u", k_hu, k_u, m)):
        for name, a in zip(("chi2", "normal", "z"), nw_noise(kh, rows)):
            out[f"{{tag}}/hyper_{{side}}_{{name}}"] = np.asarray(a)
        out[f"{{tag}}/z_{{side}}"] = np.asarray(jd._per_item_noise(kz, jnp.arange(rows), K))
    return key


def save(tag, st):
    out[f"{{tag}}/u"], out[f"{{tag}}/v"] = np.asarray(st.u), np.asarray(st.v)
    for side in ("u", "v"):
        h = getattr(st, f"hyper_{{side}}")
        out[f"{{tag}}/hyper_{{side}}_mu"] = np.asarray(h.mu)
        out[f"{{tag}}/hyper_{{side}}_lam"] = np.asarray(h.lam)
    if st.v_eval is not None:
        out[f"{{tag}}/v_eval"] = np.asarray(st.v_eval)


for mode in jd.DIST_MODES:
    for engine in jd.DIST_ENGINES:
        d = jd.DistributedBPMF(train, test, k=K, alpha=ALPHA, width="auto",
                               mode=mode, engine=engine)
        st = d.init(SEED)
        if "init/u" not in out:
            save("init", st)
            noise(st.key, "noise")
            # one block a side: shard 1's rows against counterpart block 2
            for side, plan, blk in (("v", d.v_plan, st.u), ("u", d.u_plan, st.v)):
                arrays = (plan.indices, plan.values, plan.mask, plan.seg,
                          plan.seg_dense, plan.seg_map)
                for eng in jd.DIST_ENGINES:
                    prec, rhs = jd._accumulate_block(
                        jnp.asarray(np.asarray(blk)[2]),
                        *(jnp.asarray(a[1, 2]) for a in arrays), plan.n_loc, engine=eng)
                    out[f"block/{{side}}/{{eng}}/prec"] = np.asarray(prec)
                    out[f"block/{{side}}/{{eng}}/rhs"] = np.asarray(rhs)
        save(f"sweep/{{mode}}/{{engine}}", d.sweep(st))
        if mode == "ring":
            key = st.key
            for i in range(3):
                key = noise(key, f"chain/{{engine}}/noise{{i}}")
                st = d.sweep(st)
            save(f"chain/{{engine}}", st)
            out[f"chain/{{engine}}/rmse"] = np.asarray(d.rmse(st))
np.savez(sys.argv[1], **out)
""".format(K=K, ALPHA=ALPHA, SEED=SEED)


def _port(r) -> SparseRatings:
    return SparseRatings(r.rows, r.cols, r.vals, r.shape)


@pytest.fixture(scope="module")
def data():
    ratings, _, _ = synthetic_lowrank(300, 200, k_true=8, nnz=9000, noise=0.3, seed=3)
    train, test = train_test_split(ratings, 0.1, seed=4)
    return _port(train), _port(test)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's plans' states, noise and sweeps at P = 4."""
    path = tmp_path_factory.mktemp("dist") / "reference.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", JAX_SIDE, str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(path))


def _noise(ref, tag) -> SweepNoise:
    def wishart(side):
        return WishartNoise(*(torch.tensor(ref[f"{tag}/hyper_{side}_{name}"])
                              for name in ("chi2", "normal", "z")))

    return SweepNoise(hyper_v=wishart("v"), z_v=torch.tensor(ref[f"{tag}/z_v"]),
                      hyper_u=wishart("u"), z_u=torch.tensor(ref[f"{tag}/z_u"]))


def _state(ref, tag) -> td.DistState:
    return td.dist_state_from_numpy(
        u=ref[f"{tag}/u"], v=ref[f"{tag}/v"], devices=CPU4,
        hyper_u=(ref[f"{tag}/hyper_u_mu"], ref[f"{tag}/hyper_u_lam"]),
        hyper_v=(ref[f"{tag}/hyper_v_mu"], ref[f"{tag}/hyper_v_lam"]))


def _sampler(data, mode="ring", engine="einsum", **kw) -> td.DistributedBPMF:
    train, test = data
    return td.DistributedBPMF(train, test, devices=CPU4, k=K, alpha=ALPHA, width="auto",
                              mode=mode, engine=engine, **kw)


def _assert_state(st: td.DistState, ref, tag, with_v_eval=False):
    for name in ("u", "v") + (("v_eval",) if with_v_eval else ()):
        got = torch.stack(getattr(st, name)).numpy()
        np.testing.assert_allclose(got, ref[f"{tag}/{name}"], err_msg=name, **TOL)
    for side in ("hyper_u", "hyper_v"):
        h = getattr(st, side)
        np.testing.assert_allclose(h.lam.numpy(), ref[f"{tag}/{side}_lam"], err_msg=side, **TOL)
        np.testing.assert_allclose(h.mu.numpy(), ref[f"{tag}/{side}_mu"], err_msg=side, **TOL)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
def _plan_data(name):
    if name == "synthetic":
        ratings, _, _ = synthetic_lowrank(300, 200, k_true=8, nnz=9000, noise=0.3, seed=3)
        return train_test_split(ratings, 0.1, seed=4)[0].centered()
    return chembl_like(scale=0.004, seed=0)[0].centered()


@pytest.mark.parametrize("dataset", ["synthetic", "chembl"])
@pytest.mark.parametrize("width", [32, "auto"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_partition_and_grid_plans_bit_equal_to_reference(dataset, width, n_shards):
    r = _plan_data(dataset)
    parts = {}
    for pkg, ratings in ((jp, r), (tp, _port(r))):
        u = pkg.partition_entities(ratings.degrees(0), n_shards)
        v = pkg.partition_entities(ratings.degrees(1), n_shards)
        parts[pkg] = (u, v, pkg.build_grid_plan(ratings, u, v, width=width),
                      pkg.build_grid_plan(ratings.transpose(), v, u, width=width))
    for want, got in zip(parts[jp][:2], parts[tp][:2]):
        for field in ("shard", "local", "n_loc", "ids"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    for want, got in zip(parts[jp][2:], parts[tp][2:]):
        for field in ("n_shards", "n_loc", "n_counter_loc", "width", "nnz", "indices",
                      "values", "mask", "seg", "item_ids", "seg_dense", "seg_map"):
            a, b = getattr(got, field), getattr(want, field)
            np.testing.assert_array_equal(a, b, err_msg=field)
            assert np.asarray(a).dtype == np.asarray(b).dtype, field
        assert got.stats() == want.stats()
        assert got.mask.sum() == r.nnz


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("side", ["v", "u"])
@pytest.mark.parametrize("engine", ENGINES)
def test_accumulate_block_matches_reference(data, ref, engine, side):
    """Shard 1's rows against counterpart block 2, from zero accumulators."""
    d = _sampler(data)
    part, plan = (d.v_part, d.v_plan) if side == "v" else (d.u_part, d.u_plan)
    counter = torch.tensor(ref["init/u" if side == "v" else "init/v"][2])
    blocks = td._ring_plans(plan, CPU4)
    prec = torch.zeros((part.n_loc, K, K))
    rhs = torch.zeros((part.n_loc, K))
    td._accumulate_block(prec, rhs, counter, blocks[1][2], engine=engine)
    np.testing.assert_allclose(prec.numpy(), ref[f"block/{side}/{engine}/prec"], **TOL)
    np.testing.assert_allclose(rhs.numpy(), ref[f"block/{side}/{engine}/rhs"], **TOL)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", MODES)
def test_one_sweep_matches_reference(data, ref, mode, engine):
    """One sweep from the reference's init state under its own noise."""
    d = _sampler(data, mode, engine)
    st = d.sweep(_state(ref, "init"), _noise(ref, "noise"))
    assert st.step == 1 and (st.v_eval is not None) == (mode == "async")
    _assert_state(st, ref, f"sweep/{mode}/{engine}", with_v_eval=mode == "async")


@pytest.mark.parametrize("engine", ENGINES)
def test_three_sweep_ring_chain_matches_reference(data, ref, engine):
    d = _sampler(data, "ring", engine)
    st = _state(ref, "init")
    for i in range(3):
        st = d.sweep(st, _noise(ref, f"chain/{engine}/noise{i}"))
    assert st.step == 3
    _assert_state(st, ref, f"chain/{engine}")
    assert d.rmse(st) == pytest.approx(float(ref[f"chain/{engine}/rmse"]), rel=1e-5)


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ENGINES)
def test_async_first_sweep_v_bit_equal_to_ring(data, engine):
    ring, asyn = _sampler(data, "ring", engine), _sampler(data, "async", engine)
    s0 = ring.init(SEED)
    noise = ring.draw_noise()
    _, v_ring = ring.gather_factors(ring.sweep(s0, noise))
    s1 = asyn.sweep(s0, noise)
    _, v_async = asyn.gather_factors(s1, coupled=False)
    assert np.array_equal(v_ring, v_async)
    # the coupled pair is (u, the v it conditioned on)
    assert all(torch.equal(a, b) for a, b in zip(s1.v_eval, s0.v))


@pytest.mark.parametrize("engine", ENGINES)
def test_async_rmse_within_005_of_ring_after_20_sweeps(data, engine):
    ring, asyn = _sampler(data, "ring", engine), _sampler(data, "async", engine)
    s_ring = s_async = ring.init(SEED)
    for _ in range(20):
        noise = ring.draw_noise()
        s_ring, s_async = ring.sweep(s_ring, noise), asyn.sweep(s_async, noise)
    assert abs(ring.rmse(s_ring) - asyn.rmse(s_async)) < 0.05
    assert asyn.rmse(s_async) < 0.7


def test_einsum_block_sums_keep_their_cpu_order(data):
    """The einsum engine's segment sums are order-fixed on every device; on
    the CPU they are index_add_'s, whose order the allgather plan's
    slot-sorted rows keep (its blocks follow each other, so its slots are
    not sorted)."""
    d = _sampler(data, "allgather")
    st = d.init(SEED)
    full = torch.cat(st.u)
    for p in range(P):
        plan = d._v.plans[p]
        assert plan.seg_order is not None
        prec = torch.zeros((d._v.n_loc, K, K))
        rhs = torch.zeros((d._v.n_loc, K))
        td._accumulate_block(prec, rhs, full, plan, engine="einsum")
        vm = full[plan.indices.long()] * plan.mask[..., None]
        want = torch.zeros((d._v.n_loc + 1, K, K)).index_add_(  # repro-lint: disable=ordered-sum (the CPU order held to)
            0, plan.seg, torch.einsum("rwk,rwl->rkl", vm, vm))
        assert torch.equal(prec, want[:-1])
        want = torch.zeros((d._v.n_loc + 1, K)).index_add_(  # repro-lint: disable=ordered-sum (the CPU order held to)
            0, plan.seg, torch.einsum("rwk,rw->rk", vm, plan.values * plan.mask))
        assert torch.equal(rhs, want[:-1])
    assert all(b.seg_order is None for row in _sampler(data)._v.plans for b in row)


def test_ring_exchange_moves_real_copies():
    """After s forwards shard p holds block (p - s) mod P, in a receive
    buffer of its own: the bytes moved."""
    blocks = [torch.full((3, 2), float(p)) for p in range(P)]
    ring = exchange.RingExchange(blocks, {})
    for s in range(P):
        for p in range(P):
            held = ring.held(p)
            assert float(held[0, 0]) == (p - s) % P
            assert (held.data_ptr() == blocks[p].data_ptr()) == (s == 0)
            ring.done(p)
        if s < P - 1:
            ring.forward()
            ring.advance()


def test_ring_forwarding_the_wrong_way_fails_against_allgather(data, monkeypatch):
    """The plant of chip_smoke.py phase dist: a ring that forwards to
    p - 1 misses ring-against-allgather by far more than its tolerance."""
    ring, gather = _sampler(data, "ring", "fused"), _sampler(data, "allgather", "fused")
    s0 = ring.init(SEED)
    noise = ring.draw_noise()
    want = gather.gather_factors(gather.sweep(s0, noise))
    np.testing.assert_allclose(ring.gather_factors(ring.sweep(s0, noise))[1], want[1], **TOL)
    monkeypatch.setattr(exchange.RingExchange, "shift", -1)
    got = ring.gather_factors(ring.sweep(s0, noise))
    assert not np.allclose(got[1], want[1], **TOL)


def test_shard_devices_round_robin_over_the_cards(monkeypatch):
    assert td.shard_devices(3, "cpu") == [torch.device("cpu")] * 3
    assert td.shard_devices(None, "cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(d) for d in td.shard_devices(4)] == ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    assert [str(d) for d in td.shard_devices()] == ["cuda:0", "cuda:1"]


def test_launcher_trains_the_distributed_sampler_on_the_cpu(capsys):
    bpmf_train.main(["--bpmf", "--mode", "ring", "--shards", "4", "--device", "cpu",
                     "--sweeps", "3", "--scale", "0.002"])
    out = capsys.readouterr().out
    assert "(4 shards, engine=fused, mode=ring, plan=balanced)" in out
    rmse = float(out.split("test rmse ")[1].split()[0])
    assert np.isfinite(rmse)
    # the sgld engine rides the same modes (tests/test_torch_sgld.py)
    bpmf_train.main(["--bpmf", "--mode", "async", "--engine", "sgld", "--shards", "4",
                     "--device", "cpu", "--sweeps", "3", "--scale", "0.002"])
    assert "(4 shards, engine=sgld, mode=async, plan=balanced)" in capsys.readouterr().out
