"""Request-batching serving front end for BPMF recommendations
(`repro.serve.frontend`, ported).

Requests arrive one user at a time; the kernel wants batches. The frontend
queues requests (thread-safe) and `flush()` drains the queue in
micro-batches of up to `max_batch`. Cold-start requests (ratings instead of
a user id) ride the same queue: each flush folds them in against the
current ensemble (serve/foldin.py, posterior means) and scores them with
the same top-N kernel as trained users.

The served ensemble is keyed by its epoch (the newest retained Gibbs step)
and refreshed on one of two paths:

* push: the frontend subscribes to a `PublicationChannel`; a subscriber
  thread stacks each newer window into a PosteriorEnsemble in memory and
  swaps it in. When (S, M, N, K) is unchanged the swap rebinds the current
  recommender's layout (and keeps the fold-in plan cache); otherwise it
  builds a new one.
* poll: `refresh()` compares the SampleStore's newest step with the served
  epoch and reloads from disk only on a change.

Both swap double-buffered: the old recommender serves until its successor
is built, and `flush()` captures (recommender, epoch) under the lock, so a
request scores one ensemble whichever thread published. `n_hosts` routes
requests through the serving tier (serve/cluster.py) instead of the
colocated recommender. The item shards go over `devices` (by default every
visible device of `device`'s type, so one shard on one card; `mesh=` is
the reference's spelling, and as one process is one rank it gives only
this process's device): the colocated recommender takes one shard
a device, the tier devices[:n_hosts] when there are that many, else it
stays on `device`. Ensembles, fold-in and the merge run on `device`,
"cuda" unless the CPU is asked for; every thread launches on its device's
default stream.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from repro_torch.checkpoint.samples import SampleStore
from repro_torch.data.sparse import SparseRatings
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_local_devices, serving_host_devices
from repro_torch.serve.cluster import ClusterCoordinator
from repro_torch.serve.ensemble import PosteriorEnsemble
from repro_torch.serve.foldin import FoldInPlanCache, fold_in
from repro_torch.serve.publish import ChannelSnapshot, PublicationChannel
from repro_torch.serve.topn import SeenIndex, TopNRecommender


@dataclass(frozen=True)
class RecommendResult:
    ticket: int
    items: np.ndarray    # (topk,) int32, -1 padded
    scores: np.ndarray   # (topk,) f32 posterior-mean scores
    epoch: int           # sample epoch that served the request
    latency_s: float     # enqueue -> result


@dataclass
class _Pending:
    ticket: int
    topk: int
    t_enqueue: float
    user_id: int | None = None
    item_ids: np.ndarray | None = None   # cold-start payload
    ratings: np.ndarray | None = None


class RecommendFrontend:
    def __init__(
        self,
        sample_root: str | Path | None = None,
        *,
        channel: PublicationChannel | None = None,
        subscribe: bool = True,
        wait_first_publish_s: float = 60.0,
        seen: SparseRatings | None = None,
        max_batch: int = 32,
        max_samples: int | None = None,
        devices=None,
        mesh=None,
        n_hosts: int | None = None,
        replicas: int = 1,
        engine: str | None = None,
        device="cuda",
    ):
        """seen: training ratings whose items are excluded per user.
        devices / mesh: where the item shards go; the default is every
        visible device of `device`'s type. A mesh contributes the devices
        of it this process holds (launch/mesh.py): as one process is one
        rank, only its own.
        n_hosts: serve through the tier (serve/cluster.py) with this many
        shard hosts, one a device when enough exist, instead of the
        colocated recommender; replicas: owners per item shard there.
        engine: the fold-in engine of cold-start
        requests (core.gibbs.ENGINES; "fused" and "kernel" take the
        kernels). device: "cuda" by default, raising without a card unless
        the CPU is asked for.

        channel: a PublicationChannel a co-running trainer publishes into;
        with subscribe=True a daemon thread adopts each publish as it lands,
        otherwise refresh() adopts on the caller's schedule. At least one of
        sample_root and channel is required; with only a channel the
        constructor waits up to `wait_first_publish_s` for the first draw.
        """
        if sample_root is None and channel is None:
            raise ValueError("need a sample_root, a channel, or both")
        self.device = resolve_device(device)
        self.store = SampleStore(sample_root) if sample_root is not None else None
        self.channel = channel
        self.seen = SeenIndex(seen) if seen is not None else None
        self.max_batch = max_batch
        self.max_samples = max_samples
        if mesh is not None and devices is None:
            devices = mesh_local_devices(mesh)
        self.devices = (list(devices) if devices is not None
                        else serving_host_devices(device=self.device))
        self.n_hosts = n_hosts
        self.replicas = replicas
        self.engine = engine
        self._lock = threading.Lock()
        # notified (under _lock) by every _swap: what wait_epoch() waits on
        self._swap_cond = threading.Condition(self._lock)
        self._adopt_lock = threading.Lock()  # one ensemble build at a time
        # cold-start plan schemas: similar batches share padded shapes
        self.foldin_cache = FoldInPlanCache()
        self._queue: list[_Pending] = []
        self._ticket = 0
        self._epoch: int | None = None
        self._recommender: TopNRecommender | ClusterCoordinator | None = None
        self.latencies_s: collections.deque[float] = collections.deque(maxlen=65536)
        # publish-path counters: swaps, rebinds (same-shape swaps) and
        # publish -> swap-visible latency
        self.swaps = 0
        self.rebinds = 0
        self.publish_to_swap_s: collections.deque[float] = collections.deque(maxlen=4096)
        # publishes the subscriber rejected, kept without ending its thread
        self.adopt_errors: collections.deque[Exception] = collections.deque(maxlen=64)
        self._subscriber: threading.Thread | None = None
        self._stop = threading.Event()

        # the first ensemble: from disk when the store holds draws, else the
        # trainer's first publish
        if self.store is not None and self.store.epoch() is not None:
            self.refresh()
        elif channel is not None:
            snap = channel.wait(timeout=wait_first_publish_s)
            if snap is None:
                if channel.closed:
                    raise RuntimeError(
                        "publication channel closed before the first publish "
                        "(trainer failed or finished during burn-in?)"
                    )
                raise TimeoutError(
                    f"no sample published within {wait_first_publish_s}s "
                    "and no retained samples to fall back to"
                )
            self._adopt_snapshot(snap)
        else:
            raise FileNotFoundError(f"no retained samples in {self.store.store.root}")
        if channel is not None and subscribe:
            self._subscriber = threading.Thread(
                target=self._subscriber_loop, name="publish-subscriber", daemon=True)
            self._subscriber.start()

    # ------------------------------------------------------------------
    @property
    def epoch(self) -> int:
        with self._lock:
            if self._epoch is None:
                raise RuntimeError("no ensemble adopted yet")
            return self._epoch

    @property
    def ensemble(self) -> PosteriorEnsemble:
        with self._lock:
            rec = self._recommender
        return rec.ensemble

    def refresh(self) -> bool:
        """Adopt the newest published or retained epoch; True on a swap.
        The channel first (in memory), then the SampleStore directory."""
        with self._lock:
            served = self._epoch
            have_recommender = self._recommender is not None
        if self.channel is not None:
            snap = self.channel.snapshot()
            if snap is not None and (served is None or snap.epoch > served):
                return self._adopt_snapshot(snap)
        if self.store is None:
            return False
        newest = self.store.epoch()
        if newest is None:
            raise FileNotFoundError(f"no retained samples in {self.store.store.root}")
        if served is not None and newest <= served:
            return False
        try:
            ensemble = PosteriorEnsemble.load(self.store.store.root,
                                              max_samples=self.max_samples,
                                              device=self.device)
        except (FileNotFoundError, ValueError):
            # lost a race against the trainer's prune: keep serving
            if have_recommender:
                return False
            raise
        return self._swap(ensemble, t_publish=None)

    # ------------------------------------------------------------------
    def _adopt_snapshot(self, snap: ChannelSnapshot) -> bool:
        """Build an ensemble from a channel snapshot and swap it in; the
        epoch check here only saves work, _swap() re-checks."""
        with self._lock:
            served = self._epoch
        if served is not None and snap.epoch <= served:
            return False
        draws = snap.draws
        if self.max_samples is not None:
            draws = draws[-self.max_samples:]
        return self._swap(PosteriorEnsemble(draws, device=self.device),
                          t_publish=snap.t_publish)

    def _swap(self, ensemble: PosteriorEnsemble, *, t_publish: float | None) -> bool:
        """Publish a fully built successor recommender: a rebind when the
        shapes are unchanged, a new build otherwise. Every adoption path
        comes through here, and the epoch check runs under _adopt_lock, so
        the served epoch never goes back."""
        with self._adopt_lock:
            if self._epoch is not None and ensemble.epoch <= self._epoch:
                return False  # lost the race to a newer adopt
            old = self._recommender
            rebound = False
            if old is not None:
                try:
                    recommender = old.rebind(ensemble)
                    rebound = True
                except ValueError:
                    # shape change: the plan schemas key on the item axis
                    self.foldin_cache.clear()
                    recommender = self._build_recommender(ensemble)
            else:
                recommender = self._build_recommender(ensemble)
            with self._lock:
                self._epoch = ensemble.epoch
                self._recommender = recommender
                self.swaps += 1
                self.rebinds += int(rebound)
                if t_publish is not None:
                    self.publish_to_swap_s.append(time.perf_counter() - t_publish)
                self._swap_cond.notify_all()
        return True

    def wait_epoch(self, epoch: int, timeout: float | None = None) -> bool:
        """Block until the served epoch reaches `epoch`; True on success,
        False on timeout. Woken by every swap."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._epoch is None or self._epoch < epoch:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._swap_cond.wait(remaining)
            return True

    def _build_recommender(self, ensemble: PosteriorEnsemble):
        """A new recommender for `ensemble` (boot, or a shape change). The
        seen-item index follows grown axes (new users and items get empty
        rows); an ensemble smaller than the ratings is rejected."""
        if self.seen is not None:
            want = (ensemble.n_users, ensemble.n_items)
            if self.seen.shape != want:
                self.seen = self.seen.resized(want)  # ValueError on shrink
        if self.n_hosts is not None:
            devices = None
            if len(self.devices) >= self.n_hosts:
                devices = self.devices[: self.n_hosts]
            return ClusterCoordinator(ensemble, n_hosts=self.n_hosts,
                                      replicas=self.replicas, devices=devices,
                                      device=self.device)
        return TopNRecommender(ensemble, devices=self.devices, device=self.device)

    def _subscriber_loop(self) -> None:
        """Daemon: wait on the channel and adopt each newer snapshot. A
        rejected adoption (ValueError, e.g. an ensemble smaller than the
        seen-item index) is recorded and skipped; the loop goes on."""
        rejected: int | None = None  # newest rejected epoch; skip until newer

        def adopt(snap) -> None:
            nonlocal rejected
            try:
                self._adopt_snapshot(snap)
            except ValueError as e:
                with self._lock:
                    self.adopt_errors.append(e)
                    self._swap_cond.notify_all()
                rejected = snap.epoch

        while not self._stop.is_set():
            with self._lock:
                epoch = self._epoch
            floor = epoch if rejected is None else max(epoch, rejected)
            snap = self.channel.wait(newer_than=floor, timeout=0.25)
            if snap is None:
                if self.channel.closed:
                    # a last publish can land between a timed-out wait and
                    # the closed check: adopt it before ending
                    final = self.channel.snapshot()
                    if final is not None and final.epoch > floor:
                        adopt(final)
                    return
                continue
            adopt(snap)

    def close(self) -> None:
        """Stop the subscriber thread (the channel stays usable)."""
        self._stop.set()
        if self._subscriber is not None:
            self._subscriber.join(timeout=5.0)
            self._subscriber = None

    # ------------------------------------------------------------------
    def submit(self, user_id: int, topk: int = 10) -> int:
        """Queue a trained-user request; returns a ticket flush() matches."""
        with self._lock:
            n_users = self._recommender.ensemble.n_users
            if not 0 <= user_id < n_users:
                raise ValueError(f"user id must be in [0, {n_users}), got {user_id}")
            self._ticket += 1
            self._queue.append(_Pending(ticket=self._ticket, topk=topk,
                                        t_enqueue=time.perf_counter(),
                                        user_id=int(user_id)))
            return self._ticket

    def submit_ratings(self, item_ids, ratings, topk: int = 10) -> int:
        """Queue a cold-start request: the user's ratings, not a user id."""
        item_ids = np.asarray(item_ids, np.int32)
        ratings = np.asarray(ratings, np.float32)
        if item_ids.shape != ratings.shape:
            raise ValueError(f"{item_ids.shape} item ids for {ratings.shape} ratings")
        with self._lock:
            n_items = self._recommender.ensemble.n_items
            if item_ids.size and not (0 <= item_ids.min() and item_ids.max() < n_items):
                # rejected here: one bad request must not fail its batch
                raise ValueError(f"item ids must be in [0, {n_items}), got "
                                 f"[{item_ids.min()}, {item_ids.max()}]")
            self._ticket += 1
            self._queue.append(_Pending(ticket=self._ticket, topk=topk,
                                        t_enqueue=time.perf_counter(),
                                        item_ids=item_ids, ratings=ratings))
            return self._ticket

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    # ------------------------------------------------------------------
    def flush(self) -> list[RecommendResult]:
        """Drain the queue in micro-batches; results matched by ticket."""
        with self._lock:
            batch_all, self._queue = self._queue, []
            rec = self._recommender
            epoch = self._epoch
        results: list[RecommendResult] = []
        for lo in range(0, len(batch_all), self.max_batch):
            results.extend(self._run_batch(batch_all[lo: lo + self.max_batch],
                                           rec, epoch))
        with self._lock:
            self.latencies_s.extend(r.latency_s for r in results)
        return results

    def _run_batch(self, batch: list[_Pending], rec, epoch: int
                   ) -> list[RecommendResult]:
        if not batch:
            return []
        topk = max(p.topk for p in batch)
        warm = [p for p in batch if p.user_id is not None]
        cold = [p for p in batch if p.user_id is None]
        out: dict[int, tuple[np.ndarray, np.ndarray]] = {}

        if warm:
            ids = np.asarray([p.user_id for p in warm], np.int32)
            vals, idx = rec.recommend(ids, topk, seen=self.seen)
            for r, p in enumerate(warm):
                out[p.ticket] = (vals[r], idx[r])

        if cold:
            rows = np.concatenate([np.full(len(p.item_ids), r, np.int32)
                                   for r, p in enumerate(cold)])
            ratings = SparseRatings(
                rows=rows, cols=np.concatenate([p.item_ids for p in cold]),
                vals=np.concatenate([p.ratings for p in cold]),
                shape=(len(cold), rec.ensemble.n_items),
            )
            # conditional posterior means: the same ratings served twice
            # give the same recommendations
            u_draws = fold_in(None, ratings, rec.ensemble, sample=False,
                              engine=self.engine,
                              plan_cache=self.foldin_cache)  # repro-lint: disable=guarded-field (never rebound; the cache locks itself)
            # candidate count pinned to topk + the batch's largest degree,
            # a power of two, with or without exclusions
            hint = topk + max(len(p.item_ids) for p in cold)
            hint = 1 << (hint - 1).bit_length()
            vals, idx = rec.recommend_factors(u_draws, topk,
                                              exclude=[p.item_ids for p in cold],
                                              fetch_hint=hint)
            for r, p in enumerate(cold):
                out[p.ticket] = (vals[r], idx[r])

        t_done = time.perf_counter()
        return [
            RecommendResult(ticket=p.ticket, items=out[p.ticket][1][: p.topk],
                            scores=out[p.ticket][0][: p.topk], epoch=epoch,
                            latency_s=t_done - p.t_enqueue)
            for p in batch
        ]

    # ------------------------------------------------------------------
    def latency_percentiles(self) -> dict[str, float]:
        """p50/p99 of every request served so far (seconds)."""
        with self._lock:
            lat = list(self.latencies_s)
        if not lat:
            return {"p50": float("nan"), "p99": float("nan")}
        arr = np.asarray(lat)
        return {"p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99))}
