"""Top-N serving tier: scatter/gather over resident item shards, with
per-shard replication and health-routed failover (`repro.serve.cluster`,
ported).

* Each **ShardHost** owns a resident row range of V' (its item shard) and
  the U scoring table: a routed host holds its own copy and gathers the
  rows of the user ids it is sent; cold-start rows (fold-in factors) are
  scattered to the hosts instead.

* The **ClusterCoordinator** gathers one candidate list per shard, each
  (B, min(fetch, shard rows)), and merges them with `_merge_topk`, a
  stable sort: shards hold disjoint ascending index ranges and are
  concatenated in range order, so ties resolve to the lowest global item
  index, what one unsharded top-k picks.

* **Replication and failover** (`replicas=R`): every shard is owned by R
  hosts holding identical bindings, and a request goes to the first
  healthy, epoch-current replica (`serve/faults.py::HostHealth`). A host
  that dies mid-request is routed around within the request; a shard whose
  owners are all dead is rebuilt from the committed ensemble on a new host
  (`reassignments`). Every replica is a pure function of the same
  ensemble, so results stay bit-identical to a healthy tier at the
  committed epoch while one replica per shard lives.

* Freshness: `attach(channel)` runs one subscriber loop per host. Each
  host *stages* its successor binding off the lock, and the coordinator
  *commits* an epoch once a quorum, one serveable staged replica per
  shard, has staged it: no request scores shard 0 at epoch E and shard 1
  at E-1, and a dead host is not waited for. Late replicas of the
  committed epoch flip in place.

* **Fault seams** ("adopt", "stage", "commit", "gather"): an injected
  `FaultPlan` makes chaos schedules reproducible from a seed.

`TopNRecommender` (serve/topn.py) is the colocated special case.

Placement, as the reference's single controller: this process places
each host's V' shard (and a routed host's U replica) on a device of its
own, `devices=` (host i on devices[i % len]) or `mesh=`
(launch/mesh.py::serving_host_devices); without either every host is on
the coordinator's `device`. The coordinator builds ensembles, gathers the
colocated layout's scoring rows and merges on its own device (devices[0]
by default). Every host's (B, k_eff) candidates go to it with a blocking
`.to()` before the merge, which copies nothing for a host already there.
A host on a card scores with the top-N kernel, one on
the CPU (placed there by the caller, never by the tier) with its plain
version. Host threads and request threads launch on each host's device
under its guard (`torch.cuda.device`), on that device's current (default)
stream, so a V' shard staged by one thread is complete before another
thread's top-N launch reads it; every cross-device copy is a blocking
`.to()`. Staging and every device copy run off the coordinator lock; the
flips under it are pointer swaps, except the stop-the-world `_reshard`.
"""
from __future__ import annotations

import collections
import contextlib
import math
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.serve.ensemble import PosteriorEnsemble
from repro_torch.serve.faults import (
    DEAD,
    HEALTHY,
    Clock,
    FaultDrop,
    FaultPlan,
    HostHealth,
    HostKilled,
    assert_holds,
)
from repro_torch.serve.publish import ChannelSnapshot, PublicationChannel
from repro_torch.spans import span


def shard_bounds(n_items: int, n_shards: int) -> np.ndarray:
    """n_shards + 1 ascending item-axis bounds, balanced to within one row."""
    return np.linspace(0, n_items, n_shards + 1).astype(int)


def _on_device(device: torch.device):
    """The guard a host's work runs under: its card current (the kernel
    wrappers' `_on_card` does the same for each launch), nothing on the
    CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _placed(device) -> torch.device:
    """A host's device, resolved ("cuda" without a card raises) and indexed,
    so that "cuda" and "cuda:0" are one device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _merge_topk(vals: torch.Tensor, idx: torch.Tensor, topk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard candidates (B, C), keeping the first of equal scores
    (a stable descending sort), so ties go to the lowest global index."""
    v, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    return v[:, :topk], torch.gather(idx, 1, pos[:, :topk])


class _Binding(NamedTuple):
    """One host's immutable serving state for one epoch. Requests capture
    bindings under the coordinator lock and score against them; commits
    and reshards replace bindings, never mutate them."""

    ensemble: PosteriorEnsemble
    u_replica: torch.Tensor   # (M, S*K) the U scoring table
    v_shard: torch.Tensor     # (hi-lo, S*K) resident item shard
    lo: int                   # global index of the shard's first item
    hi: int


class ShardHost:
    """One serving host: the live binding and the staged successor.

    `stage()` builds the successor off the serving path; the coordinator
    flips it under its lock once a quorum has staged the same epoch.
    `shard` is the item shard the host owns; with replicas several hosts
    own one shard. The bindings live on `device`. routed=False is the
    colocated layout of TopNRecommender: the hosts share the ensemble's U
    table where it is, the coordinator gathers the scoring rows once and
    each host receives them on its device.
    """

    def __init__(self, host_id: int, ensemble: PosteriorEnsemble, lo: int,
                 hi: int, *, device, routed: bool = True, flats=None,
                 shard: int | None = None):
        self.host_id = host_id
        self.shard = host_id if shard is None else shard
        self.device = torch.device(device)
        self.routed = routed
        self.live = self.build(ensemble, lo, hi, flats=flats)
        self.staged: _Binding | None = None

    def build(self, ensemble: PosteriorEnsemble, lo: int, hi: int, *,
              flats=None) -> _Binding:
        """Resident V' rows [lo, hi) on this host's device, and the U table:
        a routed host's copy there, the shared one for a colocated host.
        `flats` shares one scoring_matrices() result across hosts
        (construction, reshard); staging computes its own."""
        u_flat, v_flat = flats if flats is not None else ensemble.scoring_matrices()
        with _on_device(self.device):
            chunk = v_flat[lo:hi].to(self.device).contiguous()
            if self.routed:
                u_flat = u_flat.to(self.device)
        return _Binding(ensemble, u_flat, chunk, int(lo), int(hi))

    def stage(self, ensemble: PosteriorEnsemble) -> _Binding:
        """Build (but do not serve) the successor for a same-shape publish,
        on the live binding's bounds."""
        live = self.live  # snapshot: a concurrent reshard swaps the attribute
        if ensemble.shape_key() != live.ensemble.shape_key():
            raise ValueError(
                f"shape changed: {ensemble.shape_key()} vs "
                f"{live.ensemble.shape_key()}; reshard, don't stage"
            )
        return self.build(ensemble, live.lo, live.hi)

    def candidates(self, binding: _Binding, fetch: int, *,
                   rows: torch.Tensor | None = None,
                   user_ids: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """This host's (B, min(fetch, shard rows)) candidates against
        `binding`'s shard, on this host's device, indices in the global item
        numbering. Warm requests send user ids (gathered from the host's U
        table), cold ones scoring rows; either moves to the host's device."""
        with _on_device(self.device):
            if rows is None:
                rows = binding.u_replica[user_ids.to(binding.u_replica.device)]
            rows = rows.to(self.device)
            k_eff = min(fetch, binding.hi - binding.lo)
            vals, idx = ops.topn_scores(rows, binding.v_shard, k_eff)
            return vals, idx + binding.lo


class ClusterCoordinator:
    """Scatter/gather top-N over ShardHosts, with a quorum epoch barrier,
    per-shard replication and health-routed failover.

    `replicas=R` gives every item shard R owners (n_shards =
    ceil(n_hosts / R); host i owns shard i mod n_shards). `devices` places
    host i on devices[i % len(devices)] and sets n_hosts = len(devices);
    `mesh` gives them as `launch.mesh.serving_host_devices(mesh=)`: one
    entry a lead rank, each this process's device (one process is one
    rank; another process's lead rank raises). Each
    entry is resolved: a "cuda" one without a card raises, and none changes
    type. `device` is the coordinator's own (ensembles, the colocated row
    gather, the merge): devices[0] when devices are given, else "cuda",
    raising without a card unless the CPU is asked for; without devices
    every host is on it. `channel` attaches a PublicationChannel (see
    attach()). `faults` injects a chaos schedule; `clock` is the time
    source shared with the health tracker.
    """

    # hosts route user ids and gather from their own U table; the colocated
    # TopNRecommender gathers the rows once instead
    routed = True

    def __init__(
        self,
        ensemble: PosteriorEnsemble,
        *,
        n_hosts: int = 1,
        replicas: int = 1,
        devices=None,
        mesh=None,
        device=None,
        channel: PublicationChannel | None = None,
        max_samples: int | None = None,
        faults: FaultPlan | None = None,
        clock: Clock | None = None,
        heartbeat_timeout: float = 5.0,
        max_host_errors: int = 3,
    ):
        if mesh is not None and devices is None:
            from repro_torch.launch.mesh import serving_host_devices

            devices = serving_host_devices(mesh=mesh)
        if devices is not None:
            if not devices:
                raise ValueError("devices= names no device")
            devices = [_placed(d) for d in devices]
            n_hosts = len(devices)
        self.devices = devices
        self.device = resolve_device(device if device is not None
                                     else devices[0] if devices else "cuda")
        self.max_samples = max_samples
        self.replicas = max(1, int(replicas))
        n_hosts = max(1, int(n_hosts))
        self._n_shards = max(1, min(math.ceil(n_hosts / self.replicas),
                                    ensemble.n_items))
        self._layout_hosts = n_hosts
        self.faults = faults
        if clock is None:
            clock = faults.clock if faults is not None else Clock()
        self.clock = clock
        self.health = HostHealth(clock=clock, heartbeat_timeout=heartbeat_timeout,
                                 max_errors=max_host_errors)
        bounds = shard_bounds(ensemble.n_items, self._n_shards)
        flats = ensemble.scoring_matrices()  # one U/V' build shared by all
        self.hosts: list[ShardHost] = []
        self._owners: list[list[ShardHost]] = [[] for _ in range(self._n_shards)]
        for i in range(n_hosts):
            s = i % self._n_shards
            host = ShardHost(i, ensemble, bounds[s], bounds[s + 1],
                             device=(devices[i % len(devices)] if devices
                                     else self.device),
                             routed=self.routed, flats=flats, shard=s)
            self.hosts.append(host)
            self._owners[s].append(host)
            self.health.register(i)
        self._next_host_id = n_hosts
        self.ensemble = ensemble
        self._epoch = ensemble.epoch
        self._lock = threading.Lock()
        self._epoch_cond = threading.Condition(self._lock)
        self._build_lock = threading.Lock()
        self._pending: tuple[int, PosteriorEnsemble] | None = None  # (seq, ens)
        # barrier-path counters, and publish -> all-shards-fresh latency
        self.commits = 0
        self.reshards = 0
        self.reassignments = 0
        self.gather_failovers = 0
        self.publish_to_fresh_s: collections.deque[float] = collections.deque(maxlen=4096)
        # adopt failures recorded instead of ending a host loop
        self.adopt_errors: collections.deque[Exception] = collections.deque(maxlen=64)
        self.channel: PublicationChannel | None = None
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        if channel is not None:
            self.attach(channel)

    # -- layout ---------------------------------------------------------
    @property
    def n_hosts(self) -> int:
        with self._lock:
            return len(self.hosts)

    @property
    def n_shards(self) -> int:
        return self._n_shards

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def wait_epoch(self, epoch: int, timeout: float | None = None) -> bool:
        """Block until the committed epoch reaches `epoch`; True on success,
        False on timeout. Woken by commits and reshards."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._epoch < epoch:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._epoch_cond.wait(remaining)
            return True

    def _layout_kwargs(self) -> dict:
        return dict(n_hosts=self._layout_hosts, replicas=self.replicas,
                    devices=self.devices, device=self.device,
                    max_samples=self.max_samples)

    def rebind(self, ensemble: PosteriorEnsemble):
        """A new coordinator serving `ensemble` on this one's layout (same
        shard bounds, replicas and devices). Self stays servable; the caller
        swaps the new one in. Raises ValueError when the ensemble's (S, M,
        N, K) changed: the caller rebuilds."""
        with self._lock:
            current_key = self.ensemble.shape_key()
        if ensemble.shape_key() != current_key:
            raise ValueError(
                f"shape changed: {ensemble.shape_key()} vs "
                f"{current_key}; rebuild, don't rebind"
            )
        return type(self)(ensemble, **self._layout_kwargs())

    # -- fault seam -----------------------------------------------------
    def _fault(self, seam: str, host_id: int) -> None:
        """Hook point of the injected chaos schedule: kill marks the host
        dead and raises HostKilled; hang blocks until released; delay
        sleeps on the injected clock; drop raises FaultDrop."""
        if self.faults is None:
            return
        ev = self.faults.fire(seam, host_id)
        if ev is None:
            return
        if ev.action == "kill":
            self.health.kill(host_id)
            raise HostKilled(f"host {host_id} killed at seam {seam!r}")
        if ev.action == "hang":
            self.faults.hang(host_id)
        elif ev.action == "delay":
            self.clock.sleep(ev.delay_s)
        elif ev.action == "drop":
            raise FaultDrop(f"{seam!r} dropped for host {host_id}")

    # -- serving (scatter/gather with failover routing) ------------------
    def _snapshot(self) -> tuple[int, PosteriorEnsemble,
                                 list[tuple[ShardHost, _Binding]]]:
        """The epoch, ensemble and one (host, binding) per shard that one
        request scores against, routed around unhealthy replicas."""
        with self._lock:
            picks = [self._select_shard_locked(s) for s in range(self._n_shards)]
            return self._epoch, self.ensemble, picks

    def _select_shard_locked(self, s: int, exclude: set[int] = frozenset()
                             ) -> tuple[ShardHost, _Binding]:
        """The replica serving shard `s`: the first HEALTHY owner whose live
        binding is at the committed epoch; a SUSPECT one only as a
        fallback; a rebuilt replica when no owner survives at the committed
        epoch. Caller holds self._lock."""
        assert_holds(self._lock)
        fallback = None
        for h in self._owners[s]:
            if h.host_id in exclude:
                continue
            state = self.health.state(h.host_id)
            if state == DEAD:
                continue
            if h.live.ensemble.epoch != self._epoch:
                continue  # stale replica: routed around until it catches up
            if state == HEALTHY:
                return h, h.live
            if fallback is None:
                fallback = (h, h.live)
        if fallback is not None:
            return fallback
        return self._reassign_locked(s)

    def _reassign_locked(self, s: int) -> tuple[ShardHost, _Binding]:
        """Failover: every owner of shard `s` is dead or stale. Rebuild the
        shard from the committed ensemble on a new host, on the device of
        the first serveable host (the coordinator's when none is left): a
        pure function of the same ensemble, so serving stays bit-identical
        wherever the same arithmetic runs. With a channel attached the new
        host gets its own subscriber loop. Caller holds self._lock."""
        assert_holds(self._lock)
        bounds = shard_bounds(self.ensemble.n_items, self._n_shards)
        donor = next((h for h in self.hosts if self.health.serveable(h.host_id)), None)
        host = ShardHost(self._next_host_id, self.ensemble, bounds[s],
                         bounds[s + 1],
                         device=donor.device if donor is not None else self.device,
                         routed=self.routed, shard=s)
        self._next_host_id += 1
        self.hosts.append(host)
        self._owners[s].append(host)
        self.health.register(host.host_id)
        self.reassignments += 1
        if self.channel is not None and self._threads and not self._stop.is_set():
            t = threading.Thread(target=self._host_loop, args=(host,),
                                 name=f"shard-host-{host.host_id}", daemon=True)
            self._threads.append(t)
            t.start()
        return host, host.live

    def _gather_merge(self, picks: list[tuple[ShardHost, _Binding]], fetch: int,
                      *, rows=None, user_ids=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        vals, idx = [], []
        for s, (host, binding) in enumerate(picks):
            tried: set[int] = set()
            while True:
                try:
                    self._fault("gather", host.host_id)
                    v, i = host.candidates(binding, fetch, rows=rows,
                                           user_ids=user_ids)
                    break
                except HostKilled:
                    # the host died mid-request: another replica of the
                    # shard (identical binding), or a rebuilt one
                    tried.add(host.host_id)
                except FaultDrop as e:
                    # the response was lost: escalate and re-route
                    self.health.error(host.host_id, e)
                    tried.add(host.host_id)
                with self._lock:
                    self.gather_failovers += 1
                    host, binding = self._select_shard_locked(s, exclude=tried)
            vals.append(v)
            idx.append(i)
        if len(vals) == 1:
            return vals[0], idx[0]
        # the cross-device gather: each host sends only its (B, k_eff)
        # candidates to the coordinator's device, a blocking copy ordered
        # after the launch that wrote them (a no-op for a host already
        # there); the merge runs there
        vals = [v.to(self.device) for v in vals]
        idx = [i.to(self.device) for i in idx]
        return _merge_topk(torch.cat(vals, 1), torch.cat(idx, 1), fetch)

    def _serve(self, topk: int, *, rows=None, user_ids=None,
               exclude: list[np.ndarray] | None = None,
               fetch_hint: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        # spans: the ids' upload and the rows' gather, the scoring, the
        # host's wait for the lists, and the host's work on them
        with span("topn.serve", self.device):
            _, ens, picks = self._snapshot()
            with span("topn.upload", self.device):
                if user_ids is not None:
                    ids = torch.as_tensor(np.asarray(user_ids, np.int64)).to(self.device)
                    if self.routed:
                        user_ids = ids
                    else:
                        # colocated: one gather from the shared U table
                        u_table = picks[0][1].u_replica
                        rows, user_ids = u_table[ids.to(u_table.device)], None
                if rows is not None:
                    rows = rows.to(self.device)
            b = rows.shape[0] if rows is not None else user_ids.shape[0]
            fetch = topk
            if exclude is not None:
                if len(exclude) != b:
                    raise ValueError(f"{len(exclude)} exclusion lists for {b} rows")
                fetch = topk + max((len(e) for e in exclude), default=0)
            if fetch_hint is not None:
                # a hint pins the candidate count even without exclusions
                fetch = max(fetch, fetch_hint)
            # a power of two: every caller folds onto O(log n_items) kernel
            # shapes, and candidate sets (so ties and exclusions) are the
            # reference's
            fetch = 1 << (fetch - 1).bit_length()
            fetch = min(fetch, ens.n_items)
            with span("topn.score", self.device):
                vals, idx = self._gather_merge(picks, fetch, rows=rows, user_ids=user_ids)
            with span("topn.fetch", self.device):
                vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
            with span("topn.finish", self.device):
                vals = vals + np.float32(ens.global_mean)
                idx = idx.astype(np.int32)
                if exclude is None:
                    return vals[:, :topk], idx[:, :topk]
                out_v = np.full((b, topk), -np.inf, np.float32)
                out_i = np.full((b, topk), -1, np.int32)
                for r in range(b):
                    keep = ~np.isin(idx[r], exclude[r])
                    kept_v, kept_i = vals[r][keep][:topk], idx[r][keep][:topk]
                    out_v[r, : len(kept_v)] = kept_v
                    out_i[r, : len(kept_i)] = kept_i
                return out_v, out_i

    def recommend_rows(self, rows: torch.Tensor, topk: int, *,
                       exclude: list[np.ndarray] | None = None,
                       fetch_hint: int | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Top-N for explicit scoring rows (B, S*K), scattered to every
        host. `exclude` drops items per row; `fetch_hint` pins the
        candidate count. Returns host arrays (values (B, topk), indices
        (B, topk)); rows with fewer than topk candidates left are padded
        with (-inf, -1)."""
        return self._serve(topk, rows=rows, exclude=exclude,
                           fetch_hint=fetch_hint)

    def recommend(self, user_ids, topk: int, *, seen=None
                  ) -> tuple[np.ndarray, np.ndarray]:
        """Top-N for trained users; `seen` (a SeenIndex, or SparseRatings
        indexed on each call) excludes each user's rated items."""
        from repro_torch.serve.topn import SeenIndex  # topn subclasses us

        user_ids = np.asarray(user_ids, np.int32)
        exclude = fetch_hint = None
        if seen is not None:
            if not isinstance(seen, SeenIndex):
                seen = SeenIndex(seen)
            exclude = [seen[int(u)] for u in user_ids]
            fetch_hint = topk + seen.max_degree
        return self._serve(topk, user_ids=user_ids, exclude=exclude,
                           fetch_hint=fetch_hint)

    def recommend_factors(self, u_draws: torch.Tensor, topk: int, *,
                          exclude: list[np.ndarray] | None = None,
                          fetch_hint: int | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Top-N for fold-in users given their per-draw factors (S, B, K).
        `fetch_hint` pins the candidate count across cold batches."""
        _, ens, _ = self._snapshot()
        rows = ens.user_scoring_rows(u_draws)
        return self._serve(topk, rows=rows, exclude=exclude,
                           fetch_hint=fetch_hint)

    # -- freshness: channel fan-out + quorum-staged barrier ---------------
    def attach(self, channel: PublicationChannel) -> None:
        """Fan the channel's publishes out to every host: one subscriber
        loop per host, each staging its own shard as publishes land."""
        if self.channel is not None:
            raise RuntimeError("already attached to a channel")
        self.channel = channel
        with self._lock:
            threads = [
                threading.Thread(target=self._host_loop, args=(host,),
                                 name=f"shard-host-{host.host_id}", daemon=True)
                for host in self.hosts
            ]
            self._threads = threads
        for t in threads:
            t.start()

    def close(self) -> None:
        """Stop the host loops (the channel stays usable); hung hosts are
        released first so that their threads can end."""
        self._stop.set()
        if self.faults is not None:
            self.faults.release()
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=5.0)
        with self._lock:
            self._threads = []

    def _host_loop(self, host: ShardHost) -> None:
        last_staged = self.epoch
        while not self._stop.is_set():
            self.health.beat(host.host_id)
            snap = self.channel.wait(newer_than=last_staged, timeout=0.25)
            if snap is None:
                if self.channel.closed:
                    # drain: a final publish can land between a timed-out
                    # wait and the closed check
                    final = self.channel.snapshot()
                    if final is not None and final.epoch > last_staged:
                        self._adopt_in_loop(host, final)
                    return
                continue
            last_staged = max(last_staged, snap.epoch)
            if not self._adopt_in_loop(host, snap):
                return  # the host died; its replicas carry the shard

    def _adopt_in_loop(self, host: ShardHost, snap: ChannelSnapshot) -> bool:
        """Adoption with the loop's failure policy: a kill ends the loop
        (False); any other failure is recorded and escalated and the loop
        goes on to the next publish."""
        try:
            self._adopt(host, snap)
            return True
        except HostKilled:
            return False
        except Exception as e:  # noqa: BLE001 - recorded, host escalated
            self.adopt_errors.append(e)
            self.health.error(host.host_id, e)
            return True

    def _ensemble_for(self, snap: ChannelSnapshot) -> PosteriorEnsemble:
        """Stack and upload the snapshot's draw window once per publish; the
        host loops share it and stage their own bindings off any lock."""
        with self._build_lock:
            if self._pending is not None and self._pending[0] == snap.seq:
                return self._pending[1]
            draws = snap.draws
            if self.max_samples is not None:
                draws = draws[-self.max_samples:]
            ensemble = PosteriorEnsemble(draws, device=self.device)
            self._pending = (snap.seq, ensemble)
            return ensemble

    def _adopt(self, host: ShardHost, snap: ChannelSnapshot) -> None:
        try:
            self._fault("adopt", host.host_id)
            ensemble = self._ensemble_for(snap)
            # optimistic, lock-free shape precheck: staging revalidates and
            # _reshard re-checks epoch and shape under the lock
            if ensemble.shape_key() != self.ensemble.shape_key():  # repro-lint: disable=guarded-field (revalidated under lock)
                self._reshard(ensemble)
                return
            self._fault("stage", host.host_id)
            try:
                binding = host.stage(ensemble)  # the heavy part: off the lock
            except ValueError:
                # raced a reshard that changed the live shapes; _reshard
                # re-checks under the lock, so a superseded publish is a no-op
                self._reshard(ensemble)
                return
            # the commit seam fires before the lock: a hang here stalls this
            # host's commit, never the coordinator's critical section
            self._fault("commit", host.host_id)
        except FaultDrop:
            return  # the publish never reached this host; it catches up later
        with self._lock:
            if ensemble.epoch <= self._epoch:
                if (ensemble.epoch == self._epoch
                        and host.live.ensemble.epoch < self._epoch):
                    # late replica of the committed epoch: flip in place,
                    # identical to every committed binding
                    host.live = binding
                    host.staged = None
                return  # lost the race to a newer commit or reshard
            host.staged = binding
            self._commit_locked(snap.t_publish)

    def _commit_locked(self, t_publish: float | None) -> bool:
        """Flip staged hosts iff a quorum, one serveable replica per shard,
        has staged the same strictly newer epoch; dead hosts are left out,
        so a lost host cannot wedge the barrier. The newest fully covered
        epoch wins; older staged epochs are dropped (never served), newer
        ones kept for the next barrier. Caller holds self._lock."""
        assert_holds(self._lock)
        for s in range(self._n_shards):
            # a shard whose owners all died can never clear the barrier:
            # rebuild it now; with a channel attached the replacement
            # subscribes and stages the pending epoch
            if not any(self.health.serveable(h.host_id) for h in self._owners[s]):
                self._reassign_locked(s)
        staged_epochs = sorted(
            {h.staged.ensemble.epoch for h in self.hosts
             if h.staged is not None and self.health.serveable(h.host_id)},
            reverse=True,
        )
        for epoch in staged_epochs:
            if epoch <= self._epoch:
                break
            covered = {
                h.shard for h in self.hosts
                if h.staged is not None and self.health.serveable(h.host_id)
                and h.staged.ensemble.epoch == epoch
            }
            if len(covered) != self._n_shards:
                continue  # some shard's replicas are all mid-flight: hold
            committed = next(
                h.staged.ensemble for h in self.hosts
                if h.staged is not None and h.staged.ensemble.epoch == epoch
            )
            for h in self.hosts:
                if h.staged is None:
                    continue
                if h.staged.ensemble.epoch == epoch:
                    h.live, h.staged = h.staged, None
                elif h.staged.ensemble.epoch < epoch:
                    h.staged = None  # superseded; that epoch is never served
            self._epoch = epoch
            self.ensemble = committed
            self.commits += 1
            if t_publish is not None:
                self.publish_to_fresh_s.append(time.perf_counter() - t_publish)
            self._epoch_cond.notify_all()
            return True
        return False

    def _reshard(self, ensemble: PosteriorEnsemble) -> None:
        """Shape-change adoption: new shard bounds, every host rebuilt in
        one critical section. The first host thread to see the new shape
        does the work; the rest see the advanced epoch and skip. Requests in
        flight hold the old bindings and finish untorn."""
        with self._lock:
            if ensemble.epoch <= self._epoch:
                return
            bounds = shard_bounds(ensemble.n_items, self._n_shards)
            # the stop-the-world path: every host flips to the new bounds in
            # one critical section, so the device build runs under the lock
            # (shape changes only)
            flats = ensemble.scoring_matrices()  # repro-lint: disable=sync-under-lock (intentional stop-the-world)
            for h in self.hosts:
                h.live = h.build(ensemble, bounds[h.shard], bounds[h.shard + 1],
                                 flats=flats)
                h.staged = None
            self._epoch = ensemble.epoch
            self.ensemble = ensemble
            self.reshards += 1
            self._epoch_cond.notify_all()

    # -- observability ---------------------------------------------------
    def freshness_percentiles(self) -> dict[str, float]:
        """p50, p99 and max of publish -> all-shards-fresh latency (s)."""
        with self._lock:
            lat = list(self.publish_to_fresh_s)
        if not lat:
            return {"p50": float("nan"), "p99": float("nan"), "max": float("nan")}
        arr = np.asarray(lat)
        return {"p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99)), "max": float(arr.max())}

    def stats(self) -> dict:
        """Committed epoch, per-host health and binding state, per-shard
        quorum status and the barrier counters."""
        health = self.health.snapshot()
        with self._lock:
            hosts = {}
            for h in self.hosts:
                rec = dict(health.get(
                    h.host_id,
                    {"state": HEALTHY, "errors": 0, "last_beat_age_s": None},
                ))
                rec["shard"] = h.shard
                rec["device"] = str(h.device)
                rec["live_epoch"] = h.live.ensemble.epoch
                rec["staged_epoch"] = (None if h.staged is None
                                       else h.staged.ensemble.epoch)
                hosts[h.host_id] = rec
            quorum = {}
            for s in range(self._n_shards):
                owners = self._owners[s]
                quorum[s] = {
                    "owners": [h.host_id for h in owners],
                    "serveable": [h.host_id for h in owners
                                  if health.get(h.host_id, {}).get("state") != DEAD],
                    "staged": {h.host_id: h.staged.ensemble.epoch
                               for h in owners if h.staged is not None},
                }
            return {
                "epoch": self._epoch,
                "replicas": self.replicas,
                "n_shards": self._n_shards,
                "n_hosts": len(self.hosts),
                "commits": self.commits,
                "reshards": self.reshards,
                "reassignments": self.reassignments,
                "gather_failovers": self.gather_failovers,
                "adopt_errors": len(self.adopt_errors),
                "hosts": hosts,
                "quorum": quorum,
            }
