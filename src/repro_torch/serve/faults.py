"""Deterministic fault injection for the serving tier.

The port of `repro.serve.faults` (numpy only, copied so that the port
imports nothing of the JAX package): the harness that manufactures host
failures reproducibly, so serve/cluster.py's replication and quorum
machinery can be driven through every interleaving in tests instead of
hoping a race shows up under load.

* **FaultPlan**: an explicit schedule of fault events, each pinned to a
  named seam (a hook point the coordinator calls: "adopt" as a host's
  subscriber picks up a publish, "stage" as it builds the successor
  binding, "commit" just before the epoch barrier, "gather" as the
  coordinator collects a host's candidates). Events fire on the N-th
  traversal of their seam, counted per host: a chaos schedule is a pure
  function of the plan, never of thread timing. `FaultPlan.random(seed,
  ...)` derives a schedule from a seed, so a failing run replays from it.

* **Clock / StepClock**: the injected time source. Delay faults and the
  health tracker's heartbeat arithmetic go through `clock.sleep` /
  `clock.time`; a `StepClock` advances virtual time instantly.

* **HostHealth**: per-host liveness (healthy / suspect / dead) from
  heartbeats, adopt/serve error escalation and explicit kills; the
  coordinator routes around bad replicas with it and leaves dead hosts out
  of the commit quorum. `wait_state` is condition-based.

Fault actions: kill (the host dies at the seam), hang (it blocks until
`FaultPlan.release()`), delay (it sleeps `delay_s` on the injected clock),
drop (the operation at the seam is lost; the host lives on).

* **assert_holds**: the runtime half of the ``*_locked`` naming
  convention: under ``REPRO_DEBUG_LOCKS=1`` every ``*_locked`` method
  checks on entry that its caller holds the lock; otherwise it is one
  environment lookup.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np

SEAMS = ("adopt", "stage", "commit", "gather")
ACTIONS = ("kill", "hang", "delay", "drop")

HEALTHY, SUSPECT, DEAD = "healthy", "suspect", "dead"

DEBUG_LOCKS_ENV = "REPRO_DEBUG_LOCKS"


def debug_locks_enabled() -> bool:
    """True when ``REPRO_DEBUG_LOCKS`` is set to a non-empty, non-"0"
    value (the chaos CI job sets it; production leaves it unset)."""
    return os.environ.get(DEBUG_LOCKS_ENV, "") not in ("", "0")


def assert_holds(lock) -> None:
    """Debug-mode check that the calling thread holds `lock`.

    The runtime complement of the static ``*_locked`` convention: repro-lint
    proves call *sites* hold the lock lexically, this proves it dynamically
    on method *entry* under ``REPRO_DEBUG_LOCKS=1``. No-op otherwise.

    RLock/Condition expose ownership (``_is_owned``), so the check is
    exact there. A plain ``threading.Lock`` has no owner concept — the
    fallback is a non-blocking acquire probe: if it succeeds, *nobody*
    held the lock (the convention was violated by the caller); a lock held
    by a different thread is indistinguishable from held-by-us and passes.
    That asymmetry is fine for the bug class this catches: a ``*_locked``
    method reached with no lock at all.
    """
    if not debug_locks_enabled():
        return
    owned = getattr(lock, "_is_owned", None)
    if owned is not None:
        if not owned():
            raise AssertionError(
                "*_locked method entered without its lock held "
                f"(REPRO_DEBUG_LOCKS caught a convention violation on {lock!r})"
            )
        return
    if lock.acquire(blocking=False):
        lock.release()
        raise AssertionError(
            "*_locked method entered while its lock was unheld "
            f"(REPRO_DEBUG_LOCKS caught a convention violation on {lock!r})"
        )


class HostKilled(RuntimeError):
    """Raised at a seam whose fault action is ``kill``: the host is gone.

    The host's subscriber loop exits on it; the serving path catches it
    and fails over to another replica of the same shard."""


class FaultDrop(RuntimeError):
    """Raised at a seam whose fault action is ``drop``: the operation was
    lost in flight. The caller skips the operation; the host lives on."""


# ---------------------------------------------------------------------------
# injected time
# ---------------------------------------------------------------------------
class Clock:
    """Wall-clock time source — the production default."""

    def time(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class StepClock(Clock):
    """Virtual time: `sleep` advances instantly, `advance` moves time by
    hand. Delay faults and heartbeat timeouts become deterministic — a
    chaos test asserting "the tier declares a silent host suspect after
    10s" runs in microseconds of wall time."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def time(self) -> float:
        with self._lock:
            return self._t

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError(f"cannot move time backwards ({seconds})")
        with self._lock:
            self._t += float(seconds)


# ---------------------------------------------------------------------------
# the fault schedule
# ---------------------------------------------------------------------------
@dataclass
class FaultEvent:
    """One scheduled fault: fire `action` on the `at`-th traversal of
    `seam` by `host` (any host when None — counted per seam, so "the 3rd
    publish adoption anywhere hangs" is expressible)."""

    seam: str
    action: str = "kill"
    host: int | None = None
    at: int = 1
    delay_s: float = 0.0
    fired: bool = field(default=False, compare=False)

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(f"unknown seam {self.seam!r}, want one of {SEAMS}")
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown action {self.action!r}, want one of {ACTIONS}")
        if self.at < 1:
            raise ValueError(f"at must be >= 1, got {self.at}")


class FaultPlan:
    """A reproducible chaos schedule threaded through the coordinator.

    The coordinator calls `fire(seam, host)` at every hook point; the plan
    counts traversals per (seam, host) — and per seam for host-agnostic
    events — and returns the event scheduled for that exact traversal, or
    None. Each event fires at most once; `fired_log` records the order
    for post-mortem replay. Thread-safe.
    """

    def __init__(self, events: tuple[FaultEvent, ...] | list[FaultEvent] = (),
                 *, clock: Clock | None = None, hang_timeout: float | None = 30.0):
        self.events = list(events)
        self.clock = clock if clock is not None else Clock()
        self.hang_timeout = hang_timeout
        self.fired_log: list[tuple[str, int, FaultEvent]] = []
        self._hits: dict[tuple[str, int | None], int] = {}
        self._lock = threading.Lock()
        self._release = threading.Event()
        self._hanging: set[int] = set()

    @classmethod
    def random(
        cls,
        seed: int,
        *,
        n_hosts: int,
        n_events: int | None = None,
        seams: tuple[str, ...] = SEAMS,
        actions: tuple[str, ...] = ("kill", "drop", "delay"),
        max_at: int = 3,
        max_delay_s: float = 0.5,
        clock: Clock | None = None,
    ) -> "FaultPlan":
        """A schedule derived purely from `seed`: same seed, same faults,
        same trigger points — a failing chaos run replays exactly. Hangs
        are excluded by default (they need a `release()` choreographer);
        pass actions=ACTIONS to include them."""
        rng = np.random.default_rng(seed)
        if n_events is None:
            n_events = int(rng.integers(1, 2 * n_hosts + 1))
        events = [
            FaultEvent(
                seam=str(rng.choice(seams)),
                action=str(rng.choice(actions)),
                host=(int(rng.integers(0, n_hosts))
                      if rng.random() < 0.8 else None),
                at=int(rng.integers(1, max_at + 1)),
                delay_s=float(np.round(rng.uniform(0.0, max_delay_s), 3)),
            )
            for _ in range(n_events)
        ]
        return cls(events, clock=clock)

    # -- firing --------------------------------------------------------
    def fire(self, seam: str, host: int) -> FaultEvent | None:
        """Record one traversal of (seam, host); return the event scheduled
        for it, if any. At most one event fires per traversal."""
        with self._lock:
            for key in ((seam, int(host)), (seam, None)):
                self._hits[key] = self._hits.get(key, 0) + 1
            for ev in self.events:
                if ev.fired or ev.seam != seam:
                    continue
                if ev.host is not None and ev.host != host:
                    continue
                if self._hits[(seam, ev.host)] == ev.at:
                    ev.fired = True
                    self.fired_log.append((seam, int(host), ev))
                    return ev
            return None

    def hits(self, seam: str, host: int | None = None) -> int:
        with self._lock:
            return self._hits.get((seam, host), 0)

    @property
    def pending(self) -> list[FaultEvent]:
        with self._lock:
            return [ev for ev in self.events if not ev.fired]

    # -- hang choreography ---------------------------------------------
    def hang(self, host: int) -> None:
        """Block the calling (host) thread until `release()`. Bounded by
        `hang_timeout` as a safety net against a test that forgets."""
        with self._lock:
            self._hanging.add(int(host))
        try:
            self._release.wait(self.hang_timeout)
        finally:
            with self._lock:
                self._hanging.discard(int(host))

    @property
    def hanging(self) -> set[int]:
        with self._lock:
            return set(self._hanging)

    def release(self) -> None:
        """Unblock every hung host (the recover half of hang-then-recover)."""
        self._release.set()


# ---------------------------------------------------------------------------
# host liveness
# ---------------------------------------------------------------------------
class HostHealth:
    """Heartbeat + error-escalation liveness tracking for shard hosts.

    States: HEALTHY -> SUSPECT (missed heartbeats, or recent adopt/serve
    errors) -> DEAD (explicit kill, or `max_errors` accumulated errors).
    SUSPECT recovers to HEALTHY on the next heartbeat; DEAD is terminal —
    its shard is served by a replica or rebuilt on a surviving host.

    `serveable()` is what request routing consults: dead hosts never, and
    silent hosts (no heartbeat within `heartbeat_timeout` on the injected
    clock) only as a last resort. Hosts that have never beaten (no
    subscriber loop attached — the synchronous/unit-test layout) are
    serveable by construction.
    """

    def __init__(self, *, clock: Clock | None = None,
                 heartbeat_timeout: float = 5.0, max_errors: int = 3):
        self.clock = clock if clock is not None else Clock()
        self.heartbeat_timeout = heartbeat_timeout
        self.max_errors = max_errors
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._state: dict[int, str] = {}
        self._beat: dict[int, float | None] = {}
        self._errors: dict[int, list[Exception]] = {}

    def register(self, host_id: int) -> None:
        with self._lock:
            self._state.setdefault(int(host_id), HEALTHY)
            self._beat.setdefault(int(host_id), None)
            self._errors.setdefault(int(host_id), [])

    # -- signals -------------------------------------------------------
    def beat(self, host_id: int) -> None:
        """A liveness signal from the host's loop; revives SUSPECT."""
        with self._lock:
            self._beat[int(host_id)] = self.clock.time()
            if self._state.get(int(host_id)) == SUSPECT:
                self._state[int(host_id)] = HEALTHY
                self._cond.notify_all()

    def error(self, host_id: int, exc: Exception) -> None:
        """Escalate an adopt/serve failure: SUSPECT now, DEAD at
        `max_errors` accumulated errors."""
        with self._lock:
            errs = self._errors.setdefault(int(host_id), [])
            errs.append(exc)
            if self._state.get(int(host_id)) != DEAD:
                self._state[int(host_id)] = (
                    DEAD if len(errs) >= self.max_errors else SUSPECT
                )
                self._cond.notify_all()

    def kill(self, host_id: int) -> None:
        with self._lock:
            self._state[int(host_id)] = DEAD
            self._cond.notify_all()

    # -- queries -------------------------------------------------------
    def state(self, host_id: int) -> str:
        """Current state, heartbeat staleness folded in: a HEALTHY host
        whose last beat is older than the timeout reads as SUSPECT."""
        with self._lock:
            return self._state_locked(int(host_id))

    def _state_locked(self, host_id: int) -> str:
        assert_holds(self._lock)
        st = self._state.get(host_id, HEALTHY)
        if st == DEAD:
            return DEAD
        last = self._beat.get(host_id)
        if last is not None and (
            self.clock.time() - last > self.heartbeat_timeout
        ):
            return SUSPECT
        return st

    def serveable(self, host_id: int) -> bool:
        return self.state(host_id) != DEAD

    def preferred(self, host_id: int) -> bool:
        """Healthy AND heartbeat-fresh — routing picks these first and
        falls back to SUSPECT replicas only when no preferred one exists."""
        return self.state(host_id) == HEALTHY

    def errors(self, host_id: int) -> list[Exception]:
        with self._lock:
            return list(self._errors.get(int(host_id), ()))

    def snapshot(self) -> dict[int, dict]:
        """Per-host observability record for ClusterCoordinator.stats()."""
        with self._lock:
            now = self.clock.time()
            out = {}
            for hid in self._state:
                last = self._beat.get(hid)
                out[hid] = {
                    "state": self._state_locked(hid),
                    "errors": len(self._errors.get(hid, ())),
                    "last_beat_age_s": (None if last is None else now - last),
                }
            return out

    def wait_state(self, host_id: int, state: str, timeout: float | None = None
                   ) -> bool:
        """Condition-based wait until `host_id` reads as `state` (no poll
        loop; woken by beat/error/kill transitions)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._state_locked(int(host_id)) != state:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cond.wait(remaining)
            return True
