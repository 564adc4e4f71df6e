"""The serving tier placed over devices (`devices=`, `mesh=`) against the
port's single host and the JAX package's tier, on the CPU.

  * A tier over devices=["cpu"] * 4 at replicas 1 and 2, one over
    devices=["cpu"] * 3 (uneven shards), and one on mesh= a gloo (1, 1)
    host mesh give warm users with exclusions, explicit rows with a fetch hint
    and fold-in factors the single host's results bit for bit, and the
    reference's ClusterCoordinator(devices=[jax cpu] * n)'s indices with
    scores within rtol 1e-5, atol 1e-5 (the tolerance of
    tests/test_torch_serve.py::test_tier_matches_reference_tier_and_single_host:
    the scores are summed in another order than XLA's gemm).
  * Layout: host i on devices[i % len], the meta device standing in for a
    second device (bindings are built there; nothing is served from it);
    rebind keeps the devices, a rebuilt shard lands on a surviving host's
    device, stats() names each host's device.
  * `serving_host_ranks` on fake-world meshes equals the device ids of the
    reference's `serving_host_devices` on 8 forced CPU devices (a JAX
    subprocess); `serving_host_devices` cycles, and raises for another
    process's lead rank and for a card that is not there.
  * RecommendFrontend's devices / mesh / n_hosts rules against the
    reference frontend's on the same arguments.

Data: the draws of tests/test_torch_serve.py (rng 5, 40 users, 57 items,
K = 4, three draws).
"""
import json
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

import jax  # noqa: E402

from repro.checkpoint import as_retained_sample as jretained  # noqa: E402
from repro.serve import ClusterCoordinator as JCluster  # noqa: E402
from repro.serve import PosteriorEnsemble as JEnsemble  # noqa: E402
from repro.serve import PublicationChannel as JChannel  # noqa: E402
from repro.serve import RecommendFrontend as JFrontend  # noqa: E402
from repro_torch.checkpoint import as_retained_sample  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ClusterCoordinator,
    PosteriorEnsemble,
    PublicationChannel,
    RecommendFrontend,
    TopNRecommender,
)
from repro_torch.serve.faults import DEAD  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
META = torch.device("meta")
JCPU = jax.devices("cpu")[0]


def _draw(rng, m, n, k, offset=0.0):
    return {
        "u": rng.normal(size=(m, k)).astype(np.float32),
        "v": (rng.normal(size=(n, k)) + offset).astype(np.float32),
        "hyper_u_mu": rng.normal(size=k).astype(np.float32),
        "hyper_u_lam": np.eye(k, dtype=np.float32),
        "hyper_v_mu": rng.normal(size=k).astype(np.float32),
        "hyper_v_lam": 2 * np.eye(k, dtype=np.float32),
        "global_mean": np.asarray(3.25, np.float32),
        "alpha": np.asarray(2.0, np.float32),
    }


@pytest.fixture(scope="module")
def tier_draws():
    rng = np.random.default_rng(5)
    return [(s, _draw(rng, 40, 57, 4, offset=0.05 * s)) for s in (1, 2, 3)]


def _ensembles(tier_draws):
    return (PosteriorEnsemble([as_retained_sample(s, d) for s, d in tier_draws], device=CPU),
            JEnsemble([jretained(s, d) for s, d in tier_draws]))


@pytest.fixture
def host_mesh():
    """The (1, 1) host mesh on a gloo group of one rank, closed after."""
    mesh = lmesh.make_host_mesh(device="cpu")
    try:
        yield mesh
    finally:
        lmesh.close_host_group()


# ---------------------------------------------------------------------------
# (a) results
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["cpu4-r1", "cpu4-r2", "cpu3-r1", "mesh"])
def test_tier_on_devices_matches_single_host_and_reference(tier_draws, layout, request):
    ens, jens = _ensembles(tier_draws)
    replicas = 2 if "r2" in layout else 1
    n = 3 if layout.startswith("cpu3") else 4
    if layout == "mesh":
        ours = ClusterCoordinator(ens, mesh=request.getfixturevalue("host_mesh"))
        assert [h.device for h in ours.hosts] == [CPU]
    else:
        ours = ClusterCoordinator(ens, devices=["cpu"] * n, replicas=replicas)
        assert ours.n_hosts == n and ours.n_shards == n // replicas
        assert ours.devices == [CPU] * n and ours.device == CPU
        assert [h.live.v_shard.device for h in ours.hosts] == [CPU] * n
    single = TopNRecommender(ens, device=CPU)
    theirs = JCluster(jens, devices=[JCPU] * n, replicas=replicas)
    users = np.arange(12, dtype=np.int32)
    exclude = [np.arange(r, r + 4, dtype=np.int32) for r in range(12)]
    rows = single.u_flat[users]
    jax_rows = np.asarray(rows)
    u_draws = np.random.default_rng(0).normal(size=(3, 5, 4)).astype(np.float32)
    calls = [
        lambda r, t: r.recommend(users, 9),
        lambda r, t: r.recommend_rows(rows if t else jax_rows, 6, exclude=exclude,
                                      fetch_hint=16),
        lambda r, t: r.recommend_factors(torch.as_tensor(u_draws) if t else u_draws, 4),
    ]
    for call in calls:
        v, i = call(ours, True)
        sv, si = call(single, True)
        np.testing.assert_array_equal(i, si)
        np.testing.assert_array_equal(v, sv)
        jv, ji = call(theirs, False)
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# (b) layout
# ---------------------------------------------------------------------------
def test_hosts_follow_devices_rebind_keeps_them_and_stats_name_them(tier_draws):
    ens, _ = _ensembles(tier_draws)
    devices = ["cpu", "meta", "cpu", "meta", "cpu"]
    tier = ClusterCoordinator(ens, devices=devices, replicas=2)
    want = [torch.device(devices[i % len(devices)]) for i in range(5)]
    assert [h.device for h in tier.hosts] == want and tier.device == CPU
    assert [h.live.v_shard.device for h in tier.hosts] == want
    assert [h.live.u_replica.device for h in tier.hosts] == want   # routed copies
    assert tier.n_shards == 3
    assert [h["device"] for h in tier.stats()["hosts"].values()] == [str(d) for d in want]
    nxt_ens, _ = _ensembles([(s + 10, d) for s, d in tier_draws])
    nxt = tier.rebind(nxt_ens)
    assert nxt.devices == tier.devices and nxt.n_hosts == 5 and nxt.epoch == 13
    assert [h.device for h in nxt.hosts] == want
    # colocated: one shard a device, the U table left where the ensemble is
    top = TopNRecommender(ens, devices=["meta", "cpu"])
    assert top.n_shards == 2 and top.device == META
    assert [v.device for v in top.v_shards] == [META, CPU]
    assert {h.live.u_replica.device for h in top.hosts} == {CPU}
    assert top.rebind(nxt_ens).devices == [META, CPU]


def test_rebuilt_shard_lands_on_a_surviving_hosts_device(tier_draws):
    ens, _ = _ensembles(tier_draws)
    # shard 0 owned by hosts 0 and 2 (cpu), shard 1 by 1 and 3 (meta)
    mixed = ClusterCoordinator(ens, devices=["cpu", "meta"] * 2, replicas=2)
    for h in (0, 2):
        mixed.health.kill(h)
    with mixed._lock:
        host, binding = mixed._select_shard_locked(0)
    assert host.host_id == 4 and host.device == META and binding.v_shard.device == META
    assert mixed.reassignments == 1
    assert mixed.stats()["hosts"][4]["device"] == "meta"
    # on the CPU alone: served bit for bit the single host after the rebuild
    tier = ClusterCoordinator(ens, devices=["cpu"] * 4, replicas=2)
    users = np.arange(40, dtype=np.int32)
    want = TopNRecommender(ens, device=CPU).recommend(users, 7)
    for h in (1, 3):
        tier.health.kill(h)
    got = tier.recommend(users, 7)
    assert tier.reassignments == 1 and tier.health.state(1) == DEAD
    assert tier.hosts[-1].shard == 1 and tier.hosts[-1].device == CPU
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# (c), (d) launch/mesh.py
# ---------------------------------------------------------------------------
MESHES = {"data_model": ((2, 4), ("data", "model")),
          "pod_data_model": ((2, 2, 2), ("pod", "data", "model"))}

JAX_SIDE = """
import json, sys
import jax
from repro.launch.mesh import serving_host_devices

meshes = json.loads(sys.argv[1])
out = {name: [d.id for d in serving_host_devices(
           mesh=jax.make_mesh(tuple(shape), tuple(axes), devices=jax.devices()[:8]))]
       for name, (shape, axes) in meshes.items()}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_host_ids():
    """The reference's lead device ids on each of MESHES, 8 forced devices."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(MESHES)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(MESHES))
def test_serving_host_ranks_match_the_reference(name, jax_host_ids):
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = MESHES[name]
    with lmesh.fake_world(8):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        ranks = lmesh.serving_host_ranks(mesh)
        # this process is rank 7: the lead ranks are other processes'
        with pytest.raises(RuntimeError, match=f"lead rank {ranks[0]} belongs to another"):
            lmesh.serving_host_devices(mesh=mesh)
    assert ranks == jax_host_ids[name] == [0, 4]


def test_serving_host_devices_cycle_and_map_this_processs_rank(host_mesh):
    assert lmesh.serving_host_devices(device="cpu") == [CPU]
    assert lmesh.serving_host_devices(n_hosts=3, device="cpu") == [CPU] * 3
    assert lmesh.serving_host_ranks(host_mesh) == [0]
    assert lmesh.serving_host_devices(mesh=host_mesh) == [CPU]
    assert lmesh.mesh_local_devices(host_mesh) == [CPU]


def test_a_card_that_is_not_there_raises(tier_draws, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no.*available|none is"):
        lmesh.serving_host_devices(n_hosts=2)
    ens, _ = _ensembles(tier_draws)
    with pytest.raises(RuntimeError, match="none is"):
        ClusterCoordinator(ens, devices=["cpu", "cuda:0"])
    with pytest.raises(RuntimeError, match="none is"):
        TopNRecommender(ens, devices=["cuda:0"], device="cpu")


# ---------------------------------------------------------------------------
# (e) the frontend's placement rules
# ---------------------------------------------------------------------------
FRONTEND_CASES = {
    "default": dict(),
    "four_devices": dict(devices=4),
    "tier_on_two_of_four": dict(devices=4, n_hosts=2),
    "tier_replicated": dict(devices=4, n_hosts=2, replicas=2),
    "tier_on_too_few": dict(devices=2, n_hosts=4),
    "mesh": dict(mesh=True),
}


@pytest.mark.parametrize("case", sorted(FRONTEND_CASES))
def test_frontend_places_shards_as_the_reference(tier_draws, case, request):
    kw = dict(FRONTEND_CASES[case])
    n_dev = kw.pop("devices", None)
    ours_kw, theirs_kw = dict(kw), dict(kw)
    if n_dev is not None:
        ours_kw["devices"], theirs_kw["devices"] = ["cpu"] * n_dev, [JCPU] * n_dev
    if kw.pop("mesh", False):
        from repro.launch.mesh import make_host_mesh as jmesh

        ours_kw = dict(mesh=request.getfixturevalue("host_mesh"))
        theirs_kw = dict(mesh=jmesh())
    ch, jch = PublicationChannel(window=3), JChannel(window=3)
    for s, d in tier_draws:
        ch.publish(s, d)
        jch.publish(s, d)
    fe = RecommendFrontend(channel=ch, subscribe=False, device="cpu", **ours_kw)
    jfe = JFrontend(channel=jch, subscribe=False, **theirs_kw)
    rec, jrec = fe._recommender, jfe._recommender
    assert type(rec).__name__ == type(jrec).__name__
    assert (rec.n_hosts, rec.n_shards) == (jrec.n_hosts, jrec.n_shards)
    assert (rec.devices is None) == (jrec.devices is None)
    if rec.devices is not None:
        assert len(rec.devices) == len(jrec.devices)
    assert all(h.device == CPU for h in rec.hosts) and fe.device == CPU
    users = np.arange(40, dtype=np.int32)
    want = TopNRecommender(rec.ensemble, device=CPU).recommend(users, 5)
    for u in users:
        fe.submit(int(u), topk=5)
        jfe.submit(int(u), topk=5)
    res = sorted(fe.flush(), key=lambda r: r.ticket)
    jres = sorted(jfe.flush(), key=lambda r: r.ticket)
    np.testing.assert_array_equal(np.stack([r.items for r in res]), want[1])
    np.testing.assert_array_equal(np.stack([r.scores for r in res]), want[0])
    np.testing.assert_array_equal(np.stack([r.items for r in jres]), want[1])
    np.testing.assert_allclose(np.stack([r.scores for r in jres]), want[0],
                               rtol=1e-5, atol=1e-5)
