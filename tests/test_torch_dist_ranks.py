"""The distributed sampler with one item shard a rank, on the CPU.

`DistributedBPMF(mesh=)` and `DistributedSGLD(mesh=)` run in 4 processes on
a gloo group (tests/torch_dist_ranks.py, a subprocess), rank r holding
shard r of a 1-D "items" DeviceMesh and exchanging blocks with
isend/irecv and all-gathers. They are held against:

  * the port's one-process sampler at P = 4 (`devices=`), from the same
    state under the same noise: every rank's shard bit for bit, in every
    mode and engine (the fused engine through its plain version here),
    and SGLD's two steps under the noise each rank draws from its own
    generator seeded alike;
  * the JAX package's `DistributedBPMF` on 4 forced host devices, one
    sweep a mode and engine and a 3-sweep ring chain, at
    tests/test_torch_distributed.py's tolerances (rtol 1e-4, atol 1e-3;
    the chain's RMSE at rel 1e-5), on that file's data and replayed noise
    (its JAX side, run here in a subprocess of its own);
  * themselves: async's fresh v bit for bit ring's, the hyperparameters
    equal on every rank, a ring planted to forward to r - 1 far outside
    the tolerance.

The launcher under `torchrun` with 2 ranks prints its summary line. Every
subprocess runs under a timeout, and the ranks' group under one of its
own: a hang fails a test.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_distributed import JAX_SIDE  # noqa: E402

from repro_torch.core import distributed as td  # noqa: E402
from repro_torch.core.gibbs import SweepNoise  # noqa: E402
from repro_torch.core.hyper import WishartNoise  # noqa: E402
from repro_torch.core.sgld import DistributedSGLD  # noqa: E402
from repro_torch.data import synthetic_lowrank, train_test_split  # noqa: E402

TESTS = Path(__file__).resolve().parent
SRC = str(TESTS.parent / "src")
K, ALPHA, SEED, P = 16, 11.0, 7, 4
TOL = dict(rtol=1e-4, atol=1e-3)
MODES = ("ring", "allgather", "async")
ENGINES = ("einsum", "fused")
CPU4 = [torch.device("cpu")] * P
SGLD_MINIBATCH = 256                    # tests/torch_dist_ranks.py's
#: the subprocesses' limit: the JAX side takes some 40 s, the ranks 10 s
RUN_TIMEOUT_S = 240
LAUNCH = ["-m", "torch.distributed.run", "--nproc-per-node", "2", "-m",
          "repro_torch.launch.train", "--bpmf", "--mode", "ring", "--device", "cpu",
          "--sweeps", "3", "--scale", "0.002"]


def _env(**kw) -> dict:
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
                GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1", **kw)


def _finish(procs: dict) -> dict:
    logs = {}
    for name, p in procs.items():
        try:
            logs[name] = p.communicate(timeout=RUN_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        assert p.returncode == 0, f"{name} failed:\n{logs[name][-4000:]}"
    return logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX side and the launcher side by side, then the ranks on the
    JAX side's state and noise."""
    d = tmp_path_factory.mktemp("ranks")
    first = {
        "jax": subprocess.Popen(
            [sys.executable, "-c", JAX_SIDE, str(d / "reference.npz")], text=True,
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                     JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
        "launcher": subprocess.Popen([sys.executable, *LAUNCH], env=_env(), text=True,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT)}
    logs = _finish(first)
    ranks = subprocess.Popen([sys.executable, str(TESTS / "torch_dist_ranks.py"), str(d)],
                             env=_env(), text=True, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
    _finish({"ranks": ranks})
    return dict(ref=dict(np.load(d / "reference.npz")), launcher=logs["launcher"],
                ranks=[dict(np.load(d / f"rank{r}.npz")) for r in range(P)])


@pytest.fixture(scope="module")
def data():
    ratings, _, _ = synthetic_lowrank(300, 200, k_true=8, nnz=9000, noise=0.3, seed=3)
    return train_test_split(ratings, 0.1, seed=4)


def _noise(ref, tag) -> SweepNoise:
    def wishart(side):
        return WishartNoise(*(torch.tensor(ref[f"{tag}/hyper_{side}_{name}"])
                              for name in ("chi2", "normal", "z")))

    return SweepNoise(hyper_v=wishart("v"), z_v=torch.tensor(ref[f"{tag}/z_v"]),
                      hyper_u=wishart("u"), z_u=torch.tensor(ref[f"{tag}/z_u"]))


def _init(ref) -> td.DistState:
    return td.dist_state_from_numpy(
        u=ref["init/u"], v=ref["init/v"], devices=CPU4,
        hyper_u=(ref["init/hyper_u_mu"], ref["init/hyper_u_lam"]),
        hyper_v=(ref["init/hyper_v_mu"], ref["init/hyper_v_lam"]))


def _stacked(ranks: list, key: str) -> np.ndarray:
    """Every rank's shard of `key`, in rank order: (P, n_loc, K)."""
    return np.stack([r[key] for r in ranks])


def _assert_bits(ranks: list, st: td.DistState, tag: str) -> None:
    """Each rank's shard and hyperparameters equal the one-process state's
    bit for bit."""
    for name in ("u", "v") + (("v_eval",) if st.v_eval is not None else ()):
        want = torch.stack(getattr(st, name)).numpy()
        np.testing.assert_array_equal(_stacked(ranks, f"{tag}/{name}"), want, err_msg=name)
    for side in ("hyper_u", "hyper_v"):
        for f in ("mu", "lam"):
            want = getattr(getattr(st, side), f).numpy()
            for r in ranks:
                np.testing.assert_array_equal(r[f"{tag}/{side}_{f}"], want,
                                              err_msg=f"{side}.{f}")


def _assert_near_jax(ranks: list, ref: dict, tag: str, names=("u", "v")) -> None:
    for name in names:
        np.testing.assert_allclose(_stacked(ranks, f"{tag}/{name}"), ref[f"{tag}/{name}"],
                                   err_msg=name, **TOL)
    for side in ("hyper_u", "hyper_v"):
        for f in ("mu", "lam"):
            np.testing.assert_allclose(ranks[0][f"{tag}/{side}_{f}"], ref[f"{tag}/{side}_{f}"],
                                       err_msg=f"{side}.{f}", **TOL)


# ---------------------------------------------------------------------------
# the ranks against the one-process sampler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", MODES)
def test_rank_sweep_bit_equal_to_the_one_process_sweep(runs, data, mode, engine):
    d = td.DistributedBPMF(*data, devices=CPU4, k=K, alpha=ALPHA, width="auto", mode=mode,
                           engine=engine)
    st = d.sweep(_init(runs["ref"]), _noise(runs["ref"], "noise"))
    _assert_bits(runs["ranks"], st, f"sweep/{mode}/{engine}")


@pytest.mark.parametrize("engine", ENGINES)
def test_rank_ring_chain_bit_equal_to_the_one_process_chain(runs, data, engine):
    d = td.DistributedBPMF(*data, devices=CPU4, k=K, alpha=ALPHA, width="auto", mode="ring",
                           engine=engine)
    st = _init(runs["ref"])
    for i in range(3):
        st = d.sweep(st, _noise(runs["ref"], f"chain/{engine}/noise{i}"))
    _assert_bits(runs["ranks"], st, f"chain/{engine}")
    assert all(float(r[f"chain/{engine}/rmse"]) == d.rmse(st) for r in runs["ranks"])


@pytest.mark.parametrize("mode", MODES)
def test_rank_sgld_bit_equal_to_the_one_process_sgld(runs, data, mode):
    """Two steps from init(SEED) under each rank's own draws: the row ids
    and z drawn whole on every rank from a generator seeded alike."""
    d = DistributedSGLD(*data, devices=CPU4, k=K, alpha=ALPHA, width="auto", mode=mode,
                        minibatch=SGLD_MINIBATCH)
    assert d.cfg.u_rows < d.u_plan.indices.shape[2]     # the rows are sampled
    st = d.init(SEED)
    for _ in range(2):
        st = d.sweep(st)
    _assert_bits(runs["ranks"], st, f"sgld/{mode}")


# ---------------------------------------------------------------------------
# the ranks against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", MODES)
def test_rank_sweep_matches_jax(runs, mode, engine):
    names = ("u", "v", "v_eval") if mode == "async" else ("u", "v")
    _assert_near_jax(runs["ranks"], runs["ref"], f"sweep/{mode}/{engine}", names)


@pytest.mark.parametrize("engine", ENGINES)
def test_rank_ring_chain_matches_jax(runs, engine):
    _assert_near_jax(runs["ranks"], runs["ref"], f"chain/{engine}")
    assert float(runs["ranks"][0][f"chain/{engine}/rmse"]) == pytest.approx(
        float(runs["ref"][f"chain/{engine}/rmse"]), rel=1e-5)


# ---------------------------------------------------------------------------
# the ranks against themselves
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ENGINES)
def test_rank_async_fresh_v_bit_equal_to_ring(runs, engine):
    ranks = runs["ranks"]
    np.testing.assert_array_equal(_stacked(ranks, f"sweep/async/{engine}/v"),
                                  _stacked(ranks, f"sweep/ring/{engine}/v"))
    # the coupled pair is (u, the v it conditioned on): the initial v
    np.testing.assert_array_equal(_stacked(ranks, f"sweep/async/{engine}/v_eval"),
                                  runs["ref"]["init/v"])


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", MODES)
def test_rank_hyperparameters_equal_on_every_rank(runs, mode, engine):
    ranks = runs["ranks"]
    for key in [k for k in ranks[0] if k.startswith(f"sweep/{mode}/{engine}/hyper_")]:
        assert all(np.array_equal(r[key], ranks[0][key]) for r in ranks[1:]), key


def test_rank_ring_sends_a_pair_a_step_of_each_ring(runs):
    """P - 1 isend/irecv pairs a ring a rank: ring and async sweeps run two
    rings (async's u and v rings in one pass), allgather none."""
    for r in runs["ranks"]:
        assert r["pairs"].tolist() == [2 * (P - 1)] * 2 + [0] * 2 + [2 * (P - 1)] * 2


def test_rank_ring_forwarding_the_wrong_way_fails(runs):
    """The plant: the ring forwards each block to r - 1 (and receives from
    r + 1). Its v misses the right sweep's by far more than the tolerance."""
    ranks = runs["ranks"]
    want = _stacked(ranks, "sweep/ring/fused/v")
    np.testing.assert_allclose(want, _stacked(ranks, "sweep/allgather/fused/v"), **TOL)
    assert not np.allclose(_stacked(ranks, "plant/v"), want, **TOL)


# ---------------------------------------------------------------------------
# the launcher under torchrun
# ---------------------------------------------------------------------------
def test_launcher_on_two_ranks_prints_its_summary(runs):
    out = runs["launcher"]
    assert "(2 shards, engine=fused, mode=ring, plan=balanced)" in out
    assert out.count("test rmse ") == 1                 # printed by rank 0 alone
    rmse = float(out.split("test rmse ")[1].split()[0])
    assert np.isfinite(rmse)


def test_mesh_and_devices_together_raise(data):
    with pytest.raises(ValueError, match="not both"):
        td.DistributedBPMF(*data, devices=CPU4, mesh=object(), k=K)
