"""Chaos suite of the port's serving tier (serve/faults.py driving
serve/cluster.py), after the reference's tests/test_chaos.py.

Schedules are reproducible from their FaultPlan, time is injected
(StepClock), and threads are synchronised by condition waits with generous
timeouts that fail loudly: no test depends on the wall clock. Epoch-coded
draws make a torn cross-shard ensemble observable in the served scores.
The acceptance bar of the reference holds here: with replicas = 2, killing
any one host at any publish seam leaves top-N identical, bit for bit, to a
single host at the last committed epoch, and to the JAX package's top-N
(same indices, scores within rtol 1e-5, atol 1e-5).
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest-xdist runs several workers on the same cores,
# and torch's default thread count each would oversubscribe them
torch.set_num_threads(1)

from repro.checkpoint import as_retained_sample as jretained  # noqa: E402
from repro.serve import PosteriorEnsemble as JEnsemble  # noqa: E402
from repro.serve import TopNRecommender as JTopN  # noqa: E402
from repro.serve.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro_torch.checkpoint import as_retained_sample  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ClusterCoordinator,
    PosteriorEnsemble,
    PublicationChannel,
    TopNRecommender,
)
from repro_torch.serve.faults import (  # noqa: E402
    DEAD,
    HEALTHY,
    SUSPECT,
    FaultEvent,
    FaultPlan,
    HostHealth,
    StepClock,
    assert_holds,
    debug_locks_enabled,
)

M, N, K = 40, 57, 4
CPU = "cpu"
WAIT = 20.0  # generous bound for condition waits; normal paths take ms


def make_sample(step: int, *, u=None, v=None) -> dict:
    rng = np.random.default_rng(step)
    return {
        "u": rng.normal(size=(M, K)).astype(np.float32) if u is None else u,
        "v": rng.normal(size=(N, K)).astype(np.float32) if v is None else v,
        "hyper_u_mu": np.zeros(K, np.float32),
        "hyper_u_lam": np.eye(K, dtype=np.float32),
        "hyper_v_mu": np.zeros(K, np.float32),
        "hyper_v_lam": np.eye(K, dtype=np.float32),
        "global_mean": np.float32(0.0),
        "alpha": np.float32(2.0),
    }


def epoch_coded_sample(step: int) -> dict:
    """Top-1 score == step on item step % N."""
    u = np.full((M, K), 1.0 / K, np.float32)
    v = np.zeros((N, K), np.float32)
    v[step % N] = float(step)
    return make_sample(step, u=u, v=v)


def _ensemble(steps, fn=epoch_coded_sample) -> PosteriorEnsemble:
    return PosteriorEnsemble(tuple(as_retained_sample(s, fn(s)) for s in steps),
                             device=CPU)


def _single(steps, users, topk, fn=epoch_coded_sample):
    return TopNRecommender(_ensemble(steps, fn), device=CPU).recommend(users, topk)


def _assert_epoch_coded(vals, idx, *, at_least: int):
    got = float(vals[0][0])
    assert got == pytest.approx(round(got)), got
    assert idx[0][0] == int(round(got)) % N
    assert got >= at_least


def _until(pred, what: str) -> None:
    """Wait for a condition another thread brings about, failing loudly."""
    deadline = time.monotonic() + WAIT
    tick = threading.Event()
    while not pred():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        tick.wait(0.005)


def _tier(*, n_hosts=4, replicas=2, events=(), boot=1, **kw):
    ch = PublicationChannel(window=1)
    ch.publish(boot, epoch_coded_sample(boot))
    plan = FaultPlan(list(events), **kw)
    cluster = ClusterCoordinator(PosteriorEnsemble(ch.snapshot().draws, device=CPU),
                                 n_hosts=n_hosts, replicas=replicas, channel=ch,
                                 faults=plan, device=CPU)
    return ch, plan, cluster


# ---------------------------------------------------------------------------
# FaultPlan, clocks, health
# ---------------------------------------------------------------------------
def test_fault_event_validates_seam_and_action():
    with pytest.raises(ValueError, match="unknown seam"):
        FaultEvent(seam="nope")
    with pytest.raises(ValueError, match="unknown action"):
        FaultEvent(seam="adopt", action="explode")
    with pytest.raises(ValueError, match="at must be"):
        FaultEvent(seam="adopt", at=0)


def test_fault_plan_fires_on_nth_traversal_per_host_and_per_seam():
    plan = FaultPlan([FaultEvent(seam="stage", action="kill", host=1, at=3),
                      FaultEvent(seam="adopt", action="drop", host=None, at=2)])
    assert plan.fire("stage", 1) is None
    assert plan.fire("stage", 0) is None   # another host: its own count
    assert plan.fire("stage", 1) is None
    assert plan.fire("adopt", 1) is None
    ev = plan.fire("stage", 1)
    assert ev is not None and ev.action == "kill"
    ev2 = plan.fire("adopt", 3)            # the 2nd adopt anywhere
    assert ev2 is not None and ev2.action == "drop"
    assert plan.fired_log == [("stage", 1, ev), ("adopt", 3, ev2)]
    assert plan.pending == [] and plan.fire("stage", 1) is None


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_random_plans_are_the_reference_schedules(seed):
    ours = FaultPlan.random(seed, n_hosts=4)
    theirs = JFaultPlan.random(seed, n_hosts=4)
    key = [(e.seam, e.action, e.host, e.at, e.delay_s) for e in ours.events]
    assert key == [(e.seam, e.action, e.host, e.at, e.delay_s) for e in theirs.events]
    assert ours.events == FaultPlan.random(seed, n_hosts=4).events
    assert all(e.action in ("kill", "drop", "delay") for e in ours.events)


def test_step_clock_advances_without_wall_time():
    clk = StepClock()
    t0 = time.monotonic()
    clk.sleep(3600.0)
    assert time.monotonic() - t0 < 1.0 and clk.time() == pytest.approx(3600.0)
    with pytest.raises(ValueError, match="backwards"):
        clk.advance(-1.0)


def test_health_escalates_suspect_then_dead_and_heartbeats_on_the_clock():
    h = HostHealth(max_errors=3)
    h.register(0)
    assert h.state(0) == HEALTHY and h.serveable(0)
    h.error(0, RuntimeError("x"))
    assert h.state(0) == SUSPECT and h.serveable(0) and not h.preferred(0)
    h.error(0, RuntimeError("y"))
    h.error(0, RuntimeError("z"))
    assert h.state(0) == DEAD and not h.serveable(0) and len(h.errors(0)) == 3
    clk = StepClock()
    h = HostHealth(clock=clk, heartbeat_timeout=5.0)
    h.register(1)
    h.beat(1)
    clk.advance(5.1)
    assert h.state(1) == SUSPECT
    h.beat(1)
    assert h.state(1) == HEALTHY
    h.register(2)          # never beat: serveable by construction
    clk.advance(100.0)
    assert h.state(2) == HEALTHY


def test_health_wait_state_is_condition_based():
    h = HostHealth()
    h.register(0)
    assert h.wait_state(0, DEAD, timeout=0.01) is False
    t = threading.Thread(target=h.kill, args=(0,))
    t.start()
    assert h.wait_state(0, DEAD, timeout=WAIT) is True
    t.join(timeout=WAIT)


def test_assert_holds_catches_an_unheld_lock(monkeypatch):
    monkeypatch.setenv("REPRO_DEBUG_LOCKS", "1")
    assert debug_locks_enabled()
    lock = threading.Lock()
    with pytest.raises(AssertionError, match="unheld"):
        assert_holds(lock)
    with lock:
        assert_holds(lock)
    monkeypatch.setenv("REPRO_DEBUG_LOCKS", "0")
    assert not debug_locks_enabled()
    assert_holds(lock)


# ---------------------------------------------------------------------------
# replicas and failover inside a request
# ---------------------------------------------------------------------------
def test_replica_owners_hold_identical_bindings():
    cluster = ClusterCoordinator(_ensemble((1,)), n_hosts=4, replicas=2, device=CPU)
    assert cluster.n_hosts == 4 and cluster.n_shards == 2
    for s, (a, b) in enumerate(cluster._owners):
        assert a.shard == b.shard == s
        assert (a.live.lo, a.live.hi) == (b.live.lo, b.live.hi)
        assert torch.equal(a.live.v_shard, b.live.v_shard)
    assert ClusterCoordinator(_ensemble((1,)), n_hosts=2, replicas=5,
                              device=CPU).n_shards == 1


@pytest.mark.parametrize("at", [1, 2])
def test_kill_serving_host_mid_request_routes_to_replica(at):
    users = np.arange(8, dtype=np.int32)
    want_v, want_i = _single((1, 2, 3), users, 7, make_sample)
    plan = FaultPlan([FaultEvent(seam="gather", action="kill", host=None, at=at)])
    cluster = ClusterCoordinator(_ensemble((1, 2, 3), make_sample), n_hosts=4,
                                 replicas=2, faults=plan, device=CPU)
    got_v, got_i = cluster.recommend(users, 7)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_v, want_v)
    assert sum(cluster.health.state(h.host_id) == DEAD for h in cluster.hosts) == 1
    assert cluster.gather_failovers >= 1
    got_v, got_i = cluster.recommend(users, 7)
    np.testing.assert_array_equal(got_i, want_i)
    assert cluster.n_hosts == 4 and cluster.reassignments == 0


@pytest.mark.parametrize("victim", [0, 1, 2, 3])
def test_any_single_dead_host_serves_bit_identically(victim):
    users = np.arange(8, dtype=np.int32)
    want_v, want_i = _single((1, 2, 3), users, 7, make_sample)
    cluster = ClusterCoordinator(_ensemble((1, 2, 3), make_sample), n_hosts=4,
                                 replicas=2, device=CPU)
    cluster.health.kill(victim)
    got_v, got_i = cluster.recommend(users, 7)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_v, want_v)
    assert cluster.reassignments == 0 and cluster.n_hosts == 4


def test_drop_mid_gather_escalates_and_reroutes():
    users = np.arange(6, dtype=np.int32)
    want_v, want_i = _single((4,), users, 5)
    plan = FaultPlan([FaultEvent(seam="gather", action="drop", host=1)])
    cluster = ClusterCoordinator(_ensemble((4,)), n_hosts=4, replicas=2, faults=plan,
                                 device=CPU)
    got_v, got_i = cluster.recommend(users, 5)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_v, want_v)
    assert cluster.health.state(1) == SUSPECT and len(cluster.health.errors(1)) == 1


def test_killing_all_replicas_of_a_shard_reassigns_it():
    users = np.arange(8, dtype=np.int32)
    want_v, want_i = _single((1, 2), users, 7, make_sample)
    cluster = ClusterCoordinator(_ensemble((1, 2), make_sample), n_hosts=4,
                                 replicas=2, device=CPU)
    for h in cluster._owners[0]:
        cluster.health.kill(h.host_id)
    got_v, got_i = cluster.recommend(users, 7)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_v, want_v)
    assert cluster.reassignments == 1 and cluster.n_hosts == 5
    assert cluster._owners[0][-1].shard == 0
    cluster.recommend(users, 7)
    assert cluster.reassignments == 1   # the replacement serves from now on


def test_delay_fault_runs_on_the_injected_clock():
    clk = StepClock()
    plan = FaultPlan([FaultEvent(seam="gather", action="delay", host=0,
                                 delay_s=120.0)], clock=clk)
    cluster = ClusterCoordinator(_ensemble((2,)), n_hosts=2, faults=plan, device=CPU)
    t0 = time.monotonic()
    vals, idx = cluster.recommend(np.arange(3, dtype=np.int32), 1)
    assert time.monotonic() - t0 < 5.0 and clk.time() == pytest.approx(120.0)
    _assert_epoch_coded(vals, idx, at_least=2)


# ---------------------------------------------------------------------------
# the quorum barrier
# ---------------------------------------------------------------------------
def test_quorum_commits_with_one_staged_replica_per_shard():
    cluster = ClusterCoordinator(_ensemble((1,)), n_hosts=4, replicas=2, device=CPU)
    nxt = _ensemble((2,))
    a0, a1 = cluster._owners[0]
    b0, _ = cluster._owners[1]
    with cluster._lock:
        a0.staged = a0.stage(nxt)
        assert cluster._commit_locked(None) is False   # shard 1 uncovered
    assert cluster.epoch == 1
    stats = cluster.stats()
    assert stats["quorum"][0]["staged"] == {a0.host_id: 2}
    assert stats["quorum"][1]["staged"] == {}
    with cluster._lock:
        b0.staged = b0.stage(nxt)
        assert cluster._commit_locked(None) is True
    assert cluster.epoch == 2 and a1.live.ensemble.epoch == 1  # a1 is late
    vals, idx = cluster.recommend(np.arange(3, dtype=np.int32), 1)
    _assert_epoch_coded(vals, idx, at_least=2)
    # the late replica's publish flips it in place, no second commit
    ch = PublicationChannel(window=1)
    ch.publish(2, epoch_coded_sample(2))
    commits = cluster.commits
    cluster._adopt(a1, ch.snapshot())
    assert a1.live.ensemble.epoch == 2 and a1.staged is None
    assert cluster.commits == commits and cluster.epoch == 2


def test_dead_host_does_not_wedge_the_barrier():
    ch, _, cluster = _tier(events=[FaultEvent(seam="adopt", action="kill", host=2)])
    try:
        ch.publish(2, epoch_coded_sample(2))
        assert cluster.wait_epoch(2, timeout=WAIT), cluster.stats()
        assert cluster.health.wait_state(2, DEAD, timeout=WAIT)
        ch.publish(3, epoch_coded_sample(3))
        assert cluster.wait_epoch(3, timeout=WAIT), cluster.stats()
        vals, idx = cluster.recommend(np.arange(4, dtype=np.int32), 1)
        _assert_epoch_coded(vals, idx, at_least=3)
    finally:
        ch.close()
        cluster.close()


@pytest.mark.parametrize("seam", ["adopt", "stage", "commit"])
@pytest.mark.parametrize("victim", [0, 1, 2, 3])
def test_kill_any_host_mid_publish_bit_identical(victim, seam):
    """The reference's acceptance bar: any one host killed at any publish
    seam, replicas = 2: top-N equals the single host's at the last
    committed epoch, bit for bit, and the JAX package's; the next publish
    commits."""
    ch, _, cluster = _tier(events=[FaultEvent(seam=seam, action="kill", host=victim)])
    users = np.arange(8, dtype=np.int32)
    try:
        for step in (2, 3):
            ch.publish(step, epoch_coded_sample(step))
            assert cluster.wait_epoch(step, timeout=WAIT), cluster.stats()
            want_v, want_i = _single((step,), users, 5)
            got_v, got_i = cluster.recommend(users, 5)
            np.testing.assert_array_equal(got_i, want_i)
            np.testing.assert_array_equal(got_v, want_v)
        jv, ji = JTopN(JEnsemble((jretained(3, epoch_coded_sample(3)),))).recommend(
            users, 5)
        np.testing.assert_array_equal(got_i, np.asarray(ji))
        np.testing.assert_allclose(got_v, np.asarray(jv), rtol=1e-5, atol=1e-5)
        assert cluster.health.state(victim) == DEAD and cluster.reassignments == 0
    finally:
        ch.close()
        cluster.close()


def test_single_replica_dead_host_is_reassigned_not_wedged():
    ch, _, cluster = _tier(n_hosts=2, replicas=1,
                              events=[FaultEvent(seam="adopt", action="kill", host=0)])
    try:
        ch.publish(2, epoch_coded_sample(2))
        assert cluster.health.wait_state(0, DEAD, timeout=WAIT)
        ch.publish(3, epoch_coded_sample(3))
        assert cluster.wait_epoch(3, timeout=WAIT), cluster.stats()
        assert cluster.reassignments >= 1
        vals, idx = cluster.recommend(np.arange(4, dtype=np.int32), 1)
        _assert_epoch_coded(vals, idx, at_least=3)
    finally:
        ch.close()
        cluster.close()


def test_drop_at_adopt_host_catches_up_on_next_publish():
    ch, _, cluster = _tier(events=[FaultEvent(seam="adopt", action="drop", host=3)])
    try:
        ch.publish(2, epoch_coded_sample(2))
        assert cluster.wait_epoch(2, timeout=WAIT), cluster.stats()
        ch.publish(3, epoch_coded_sample(3))
        assert cluster.wait_epoch(3, timeout=WAIT), cluster.stats()
        _until(lambda: cluster.hosts[3].live.ensemble.epoch == 3, "host 3 to catch up")
    finally:
        ch.close()
        cluster.close()


def test_hang_then_recover():
    ch, plan, cluster = _tier(events=[FaultEvent(seam="stage", action="hang", host=1)],
                              hang_timeout=WAIT)
    try:
        ch.publish(2, epoch_coded_sample(2))   # host 1 hangs mid-stage
        assert cluster.wait_epoch(2, timeout=WAIT), cluster.stats()
        _until(lambda: plan.hanging == {1}, "host 1 to hang")
        vals, idx = cluster.recommend(np.arange(4, dtype=np.int32), 1)
        _assert_epoch_coded(vals, idx, at_least=2)
        plan.release()
        _until(lambda: cluster.hosts[1].live.ensemble.epoch == 2, "the late flip")
        ch.publish(3, epoch_coded_sample(3))
        assert cluster.wait_epoch(3, timeout=WAIT), cluster.stats()
    finally:
        plan.release()
        ch.close()
        cluster.close()


def test_shard_stalled_on_both_replicas_holds_the_epoch():
    """Both owners of shard 1 hang mid-stage: the epoch must not advance on
    shard 0 alone (no torn cross-shard ensemble); released, it commits."""
    ch, plan, cluster = _tier(events=[
        FaultEvent(seam="stage", action="hang", host=1),
        FaultEvent(seam="stage", action="hang", host=3)], hang_timeout=WAIT)
    try:
        ch.publish(2, epoch_coded_sample(2))
        _until(lambda: plan.hanging == {1, 3}, "shard 1's owners to hang")
        _until(lambda: set(cluster.stats()["quorum"][0]["staged"].values()) == {2},
               "shard 0 to stage")
        assert cluster.epoch == 1
        vals, idx = cluster.recommend(np.arange(4, dtype=np.int32), 1)
        _assert_epoch_coded(vals, idx, at_least=1)
        assert float(vals[0][0]) == 1.0
        plan.release()
        assert cluster.wait_epoch(2, timeout=WAIT), cluster.stats()
    finally:
        plan.release()
        ch.close()
        cluster.close()


def test_shape_change_reshards_every_host():
    ch = PublicationChannel(window=2)
    ch.publish(1, epoch_coded_sample(1))
    cluster = ClusterCoordinator(PosteriorEnsemble(ch.snapshot().draws, device=CPU),
                                 n_hosts=4, replicas=2, channel=ch, device=CPU)
    try:
        ch.publish(2, epoch_coded_sample(2))   # the window grows: S 1 -> 2
        assert cluster.wait_epoch(2, timeout=WAIT), cluster.stats()
        assert cluster.reshards == 1
        assert all(h.live.ensemble.n_samples == 2 for h in cluster.hosts)
        users = np.arange(4, dtype=np.int32)
        want_v, want_i = _single((1, 2), users, 3)
        got_v, got_i = cluster.recommend(users, 3)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_v, want_v)
    finally:
        ch.close()
        cluster.close()


# ---------------------------------------------------------------------------
# randomized schedules
# ---------------------------------------------------------------------------
def _run_schedule(seed: int) -> None:
    """One randomized chaos run, a pure function of `seed`."""
    ctx = f"schedule seed={seed}"
    clk = StepClock()
    plan = FaultPlan.random(seed, n_hosts=4, clock=clk, max_delay_s=5.0)
    ch = PublicationChannel(window=1)
    ch.publish(1, epoch_coded_sample(1))
    cluster = ClusterCoordinator(PosteriorEnsemble(ch.snapshot().draws, device=CPU),
                                 n_hosts=4, replicas=2, channel=ch, faults=plan,
                                 device=CPU)
    users = np.arange(4, dtype=np.int32)
    try:
        observed = [cluster.epoch]
        for step in range(2, 6):
            ch.publish(step, epoch_coded_sample(step))
            before = cluster.epoch
            vals, idx = cluster.recommend(users, 1)
            got = float(vals[0][0])
            assert got == pytest.approx(round(got)), (ctx, got)
            assert idx[0][0] == int(round(got)) % N, (ctx, got, idx[0][0])
            assert got >= before >= 1, (ctx, got, before)
            observed.append(cluster.epoch)
        assert observed == sorted(observed), (ctx, observed)
        step = 6
        for _ in range(len(plan.events) + 3):
            ch.publish(step, epoch_coded_sample(step))
            if cluster.wait_epoch(step, timeout=WAIT):
                break
            step += 1
        else:
            pytest.fail(f"{ctx}: barrier wedged; stats={cluster.stats()}")
        want_v, want_i = _single((step,), users, 3)
        got_v, got_i = cluster.recommend(users, 3)
        np.testing.assert_array_equal(got_i, want_i, err_msg=ctx)
        np.testing.assert_array_equal(got_v, want_v, err_msg=ctx)
    finally:
        plan.release()
        ch.close()
        cluster.close()


@pytest.mark.parametrize("seed", range(6))
def test_randomized_schedule_preserves_invariants(seed):
    _run_schedule(seed)


def test_schedule_under_debug_locks(monkeypatch):
    """One schedule with every *_locked method checking its lock on entry."""
    monkeypatch.setenv("REPRO_DEBUG_LOCKS", "1")
    _run_schedule(11)
