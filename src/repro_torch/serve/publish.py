"""Push-based sample publication: trainer -> live server, no disk poll.

The port of `repro.serve.publish` (pure Python, copied so that the port
imports nothing of the JAX package). The trainer writes each retained
post-burn-in draw into a `PublicationChannel`
(`GibbsSampler.run(..., publish=channel)`, beside the durable SampleStore
write); a live `RecommendFrontend` and the serving tier's host loops
(`ClusterCoordinator.attach`) subscribe and adopt it in memory.

Double buffering: `publish()` builds the next window off the lock
(copy-on-write over an immutable tuple of draws), then flips the snapshot
reference under it; `snapshot()` grabs the current reference. A reader
holding last epoch's snapshot keeps serving it until its own swap is done.

Ordering: draws are windowed by Gibbs step and the channel epoch is the
newest step ever accepted, so the epoch is monotone even when publishes
arrive out of order (a straggler lands in the window but cannot move the
epoch back; a duplicate step is dropped).

A draw is host arrays (the trainer copies it off the card once); each
subscriber stacks and uploads the window it adopts.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, NamedTuple

from repro_torch.checkpoint.samples import RetainedSample, as_retained_sample


class ChannelSnapshot(NamedTuple):
    """One immutable published state: what a subscriber adopts atomically."""

    epoch: int                          # newest step in the window (monotone)
    seq: int                            # bumps once per accepted publish
    draws: tuple[RetainedSample, ...]   # window, oldest first, step-sorted
    t_publish: float                    # perf_counter when epoch was published


class PublicationChannel:
    """In-memory keep-last-`window` channel of retained Gibbs draws.

    Thread-safe; one trainer (writer) and any number of subscribers
    (readers). Closed channels wake all waiters — `wait()` returning None
    with `closed` set is the end-of-stream signal a serving loop drains on.
    """

    def __init__(self, *, window: int = 16):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._snapshot: ChannelSnapshot | None = None
        self._times: dict[int, float] = {}   # step -> publish wall time
        self._closed = False
        self._callbacks: list[Callable[[ChannelSnapshot], None]] = []

    # -- writer side ---------------------------------------------------
    def publish(self, step: int, sample: dict) -> bool:
        """Offer one retained draw; returns False if it was dropped as stale
        (duplicate step, or older than everything a full window retains).
        `sample` carries exactly the SampleStore key schema (SAMPLE_KEYS).
        """
        draw = as_retained_sample(step, sample)
        t_now = time.perf_counter()
        with self._lock:
            if self._closed:
                raise RuntimeError("publish() on a closed channel")
            old = self._snapshot
            draws = old.draws if old is not None else ()
            if any(d.step == step for d in draws):
                return False
            merged = sorted(draws + (draw,), key=lambda d: d.step)
            merged = merged[-self.window:]
            if not any(d is draw for d in merged):
                return False  # straggler older than a full window
            epoch = max(step, old.epoch if old is not None else step)
            self._times[step] = t_now
            for stale in set(self._times) - {d.step for d in merged}:
                del self._times[stale]
            snap = ChannelSnapshot(
                epoch=epoch,
                seq=(old.seq + 1) if old is not None else 1,
                draws=tuple(merged),
                t_publish=self._times[epoch],
            )
            self._snapshot = snap
            callbacks = list(self._callbacks)
            self._cond.notify_all()
        for cb in callbacks:  # outside the lock: a slow subscriber must not
            cb(snap)          # stall the trainer's next publish
        return True

    def close(self) -> None:
        """End of stream (trainer finished); wakes every waiter."""
        with self._lock:
            self._closed = True
            self._cond.notify_all()

    # -- reader side ---------------------------------------------------
    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    @property
    def epoch(self) -> int | None:
        with self._lock:
            return self._snapshot.epoch if self._snapshot else None

    @property
    def seq(self) -> int:
        """Number of accepted publishes so far (0 before the first)."""
        with self._lock:
            return self._snapshot.seq if self._snapshot else 0

    def snapshot(self) -> ChannelSnapshot | None:
        """The current published state, or None before the first publish.
        The returned tuple is immutable — adopt it without further locking.
        """
        with self._lock:
            return self._snapshot

    def publish_time(self, step: int) -> float | None:
        """perf_counter timestamp of `step`'s publish, while it is windowed:
        the freshness clock."""
        with self._lock:
            return self._times.get(step)

    def wait(
        self, *, newer_than: int | None = None, timeout: float | None = None
    ) -> ChannelSnapshot | None:
        """Block until a snapshot with epoch > `newer_than` exists (any
        snapshot when None). Returns it, or None on timeout / closed-and-
        nothing-newer — check `closed` to tell the two apart."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._lock:
            while True:
                snap = self._snapshot
                if snap is not None and (newer_than is None or snap.epoch > newer_than):
                    return snap
                if self._closed:
                    return None
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        return None
                self._cond.wait(remaining)

    def subscribe(self, callback: Callable[[ChannelSnapshot], None]
                  ) -> Callable[[], None]:
        """Register a push callback, invoked (outside the channel lock, in
        the publisher's thread) with each new snapshot. Keep callbacks
        cheap — flag-and-return; heavy adoption belongs on the subscriber's
        own thread (see RecommendFrontend's subscriber loop). Returns an
        unsubscribe function."""
        with self._lock:
            self._callbacks.append(callback)

        def unsubscribe() -> None:
            with self._lock:
                if callback in self._callbacks:
                    self._callbacks.remove(callback)

        return unsubscribe
