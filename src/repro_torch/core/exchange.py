"""The collectives of the distributed sampler: P shards in one process, or
one shard a rank of a torch.distributed group.

The JAX package runs `core/distributed.py` as one program over a mesh of P
devices (shard_map) and exchanges counterpart blocks with lax.ppermute,
lax.all_gather and lax.psum. The port has two exchanges with one
interface (`ring(blocks)`, `all_gather(blocks, device)`, `psum(parts)`,
`n`, `shards`: the global shard ids this process holds, in the order of
`blocks` and `parts`):

`LocalExchange`: one process holds the P shards, shard p's tensors on
devices[p] (several shards may share a card), and each collective is a
copy or a fixed-order sum between the shards' tensors:

  RingExchange  ppermute p -> p + 1 mod P. Each step's blocks are copied
                on the copy stream of the sending card into one of two
                receive buffers a shard, after the event where the block
                was produced and after the last reads of that buffer; the
                accumulate that consumes a block waits on the copy's event.
                The copies of step s + 1 thus run beside the accumulates
                of step s (the "both" region of the paper's Fig 6). On one
                card the copy stands in for the link: it moves the bytes.
  deliver       tensors of one card copied to another the same way, for
                what a shard's solve reads from shard 0's card (the
                hyperparameters, the shard's rows of the noise).
  join          one card's stream waits for every other card's, so that
                a synchronize of that card waits for all of them.
  all_gather    the P blocks concatenated on one shard's device.
  psum          a sum over shards 0..P-1 in that order on shard 0's
                device, then a copy to each shard's device.

A copy between two cards runs where PyTorch runs it, on the current
stream of the source card, and fences it with the current stream of the
destination card: that stream waits for the copy, and the copy for
everything queued there before it. The ring makes the sending card's copy
stream current on the source and the receiving card's landing stream, on
which nothing else is queued, current on the destination, so that no
compute stream is fenced to another card's: the four cards' accumulates
run side by side, each waiting only on the copy it reads. Each card's
forwards are the span `dist.exchange`, timed on its copy stream; each wait
of a compute stream on a copy is the span `dist.wait`, timed on that
stream (`repro_torch/spans.py`).

`RankExchange`: one process a shard, rank r of a 1-D DeviceMesh over the
dim "items", and each collective a message:

  RankRing      ppermute r -> r + 1 mod P: each step's send of the held
                block to r + 1 and receive from r - 1 go out together
                (`dist.batch_isend_irecv`) before the accumulate of the
                held block, and are waited on only where the next step
                needs the received block: the paper's asynchronous
                exchange, hidden except for that wait. P = 1 sends nothing.
  all_gather    `all_gather_into_tensor` (NCCL) or `all_gather` (gloo), in
                rank order.
  psum          the parts all-gathered, then summed in rank order 0..P-1
                on every rank by `psum` above: not `all_reduce`, whose
                order neither NCCL nor gloo fixes. So the ranks give the
                one-process run's bits.

The group's backend decides how a card's block travels: NCCL moves it
from card to card; gloo moves host tensors only, so a block on the card is
staged through pinned host buffers (a device-to-host copy on a copy
stream, the send issued once that copy is complete, the receive landing in
a pinned buffer and copied to the card before the block is read). The
caller chose the backend; nothing here switches it. NCCL does not take two
ranks on one card, and `RankExchange` says so rather than let its init
fail.

No atomics: every sum runs in a fixed order, so the exchange modes give
the same bits on every run. On the CPU the copies are plain copies.

Each collective runs under `launch/cost.py::exchanging()`: what the ops
inside it write is the exchange's bytes to the dry-run's cost counter, the
analog of the JAX package's collective bytes.
"""
from __future__ import annotations

import contextlib
import time
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.launch.cost import exchanging
from repro_torch.spans import span


def _event_now(device: torch.device) -> torch.cuda.Event:
    """An event recorded on the current stream of `device`: everything
    queued there so far."""
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class RingExchange:
    """lax.ppermute forward over a ring of P blocks, shard p's on its device.

    At step 0 shard p holds blocks[p]; each `forward()` issues the copies
    that deliver the next step's blocks, shard p's block going to shard
    p + shift; `held(p)` is shard p's block at the current step (the
    current stream waits for its copy), `done(p)` marks the current
    stream's reads of it issued, and `advance()` moves to the next step.
    `copy_streams` maps a card to the stream its copies out run on,
    `landing` a card to the stream that fences the copies into it from
    another card (not needed where every shard shares one card).
    """

    #: where shard p's block goes at each step: lax.ppermute's
    #: [(i, (i + 1) % P)]
    shift = 1

    def __init__(self, blocks: Sequence[torch.Tensor],
                 copy_streams: dict[torch.device, torch.cuda.Stream],
                 landing: dict[torch.device, torch.cuda.Stream] | None = None):
        self.blocks = list(blocks)
        self.devices = [b.device for b in self.blocks]
        self.copy_streams = copy_streams
        self.landing = {} if landing is None else landing
        # two receive buffers a shard: a step's copy writes the one its
        # block did not arrive in
        self._recv = [[torch.empty_like(b) for _ in range(2)] for b in self.blocks]
        self._slot = 0                        # the buffer the next forward writes
        self._held_slot: int | None = None    # the buffer the held blocks are in
        # events after which a buffer is free: its reads at the step it was held
        self._reads = [[[], []] for _ in self.blocks]
        self._reading: list[list] = [[] for _ in self.blocks]
        self._ready: list = [None] * len(self.blocks)
        self._next: list | None = None

    def held(self, p: int) -> torch.Tensor:
        ev, dev = self._ready[p], self.devices[p]
        with span("dist.wait", dev):
            if ev is not None:
                torch.cuda.current_stream(dev).wait_event(ev)
        return self.blocks[p]

    def done(self, p: int) -> None:
        if self.devices[p].type == "cuda":
            self._reading[p].append(_event_now(self.devices[p]))

    def forward(self) -> None:
        with exchanging():
            self._forward()

    def _forward(self) -> None:
        n = len(self.blocks)
        slot = self._slot
        nxt, ready = [None] * n, [None] * n
        # where each held block was produced: its copy, or the current
        # stream for the blocks the ring started from
        made = [self._ready[p] if self._ready[p] is not None
                else _event_now(d) if d.type == "cuda" else None
                for p, d in enumerate(self.devices)]
        for dst in range(n):
            src = (dst - self.shift) % n
            buf = self._recv[dst][slot]
            block = self.blocks[src]
            if buf.device.type != "cuda":
                with span("dist.exchange", block.device):
                    nxt[dst] = buf.copy_(block)
                continue
            waits = [made[src]] + self._reads[dst][slot]
            ready[dst] = _copy(buf, block, self.copy_streams, self.landing,
                               [ev for ev in waits if ev is not None], "dist.exchange")
            self._reading[src].append(ready[dst])
            nxt[dst] = buf
        self._next = (nxt, ready)

    def advance(self) -> None:
        if self._held_slot is not None:
            for p in range(len(self.blocks)):
                self._reads[p][self._held_slot] = self._reading[p]
        self._reading = [[] for _ in self.blocks]
        self.blocks, self._ready = self._next
        self._next = None
        self._held_slot, self._slot = self._slot, 1 - self._slot


def _copy(dst: torch.Tensor, src: torch.Tensor, copy_streams: dict, landing: dict,
          waits: Sequence[torch.cuda.Event], name: str | None = None) -> torch.cuda.Event:
    """dst <- src on the copy stream of src's card once `waits` have
    passed, fenced on dst's card by its landing stream (the module
    docstring); the event after which dst holds the copy. With a `name`
    the copy is that span, timed on the copy stream from the end of the
    waits."""
    stream = copy_streams[src.device]
    land = stream if dst.device == src.device else landing[dst.device]
    for ev in waits:
        stream.wait_event(ev)
    with span(name, src.device, stream=stream) if name else contextlib.nullcontext():
        with torch.cuda.stream(land), torch.cuda.stream(stream):
            dst.copy_(src, non_blocking=True)
    done = torch.cuda.Event()
    done.record(stream)
    # the caching allocator must not hand either tensor out again before
    # the copy has run
    dst.record_stream(land)
    src.record_stream(stream)
    return done


def all_gather(blocks: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """lax.all_gather + reshape: the P blocks in shard order, stacked along
    rows on `device`."""
    with exchanging():
        return torch.cat([b.to(device) for b in blocks])


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """lax.psum: the parts summed in shard order on the first part's device."""
    total = parts[0]
    with exchanging():
        for part in parts[1:]:
            total = total + part.to(total.device)
    return total


class LocalExchange:
    """The P shards of one process: `RingExchange`, `deliver`,
    `all_gather`, `psum`. `copy_streams` maps a card to the stream its
    copies out run on, `landing` a card to the stream that fences the
    copies into it (`RingExchange`)."""

    def __init__(self, n: int, copy_streams: dict[torch.device, torch.cuda.Stream],
                 landing: dict[torch.device, torch.cuda.Stream] | None = None):
        self.n = n
        self.shards = tuple(range(n))
        self.copy_streams = copy_streams
        self.landing = {} if landing is None else landing

    def ring(self, blocks: Sequence[torch.Tensor]) -> RingExchange:
        return RingExchange(blocks, self.copy_streams, self.landing)

    def deliver(self, tensors: Sequence[torch.Tensor], device: torch.device
                ) -> tuple[list[torch.Tensor], torch.cuda.Event | None]:
        """`tensors`, all on one card and complete on its current stream
        as of now, copied to `device` on the copy streams; and the event
        that `device`'s stream must wait on before it reads them (None
        where nothing was copied between cards)."""
        src = tensors[0].device
        if device == src or device.type != "cuda" or src.type != "cuda":
            return [t.to(device) for t in tensors], None
        made, done = _event_now(src), None
        out = []
        with exchanging():
            for t in tensors:
                o = torch.empty_like(t, device=device)
                done = _copy(o, t, self.copy_streams, self.landing, [made])
                out.append(o)
        return out, done

    def join(self, device: torch.device) -> None:
        """`device`'s current stream waits for what every other card's
        current stream holds, so that a synchronize of `device` waits for
        all of them. The host does not wait."""
        if device.type != "cuda":
            return
        stream = torch.cuda.current_stream(device)
        for card in self.copy_streams:
            if card != device:
                stream.wait_event(_event_now(card))

    def all_gather(self, blocks: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
        return all_gather(blocks, device)

    def psum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return psum(parts)


def mesh_shard(mesh) -> tuple[int, torch.device]:
    """The shard this rank of a 1-D DeviceMesh over "items" holds, and its
    device: the current card for a "cuda" mesh, the CPU for a "cpu" one."""
    if mesh.ndim != 1 or mesh.mesh_dim_names != ("items",):
        raise ValueError("the distributed sampler takes a 1-D mesh over the dim 'items', "
                         f"got {mesh.mesh_dim_names} of shape {tuple(mesh.mesh.shape)}")
    if mesh.device_type == "cuda":
        return mesh.get_local_rank(), resolve_device(
            torch.device("cuda", torch.cuda.current_device()))
    return mesh.get_local_rank(), resolve_device(mesh.device_type)


class RankExchange:
    """This rank's shard of a 1-D DeviceMesh over "items": rank r holds
    shard r on `device` (the current card for a "cuda" mesh, else the
    CPU). `times` adds up, over every ring of this exchange, the
    isend/irecv pairs waited on, their seconds from issue to the end of
    their wait, and the seconds the host spent blocked in those waits."""

    def __init__(self, mesh):
        self.rank, self.device = mesh_shard(mesh)
        self.group = mesh.get_group("items")
        self.n = dist.get_world_size(self.group)
        self.shards = (self.rank,)
        self.backend = dist.get_backend(self.group)
        on_card = self.device.type == "cuda"
        if on_card and self.backend == "nccl" and self.n > 1:
            self._one_rank_a_card()
        # gloo moves host tensors only: a card's blocks go through pinned buffers
        self.staged = on_card and self.backend == "gloo"
        self.copy_stream = torch.cuda.Stream(self.device) if on_card else None
        self.times = {"pairs": 0, "pair_s": 0.0, "wait_s": 0.0}

    def _one_rank_a_card(self) -> None:
        """NCCL refuses two ranks on one card ("Duplicate GPU detected" at
        its first collective): compare the ranks' cards over a gloo group
        first and raise with the reason."""
        side = dist.new_group(dist.get_process_group_ranks(self.group), backend="gloo")
        cards = [None] * self.n
        dist.all_gather_object(cards, str(torch.cuda.get_device_properties(self.device).uuid),
                               group=side)
        dist.destroy_process_group(side)
        if len(set(cards)) < self.n:
            raise RuntimeError(
                f"NCCL takes one rank a card, and these {self.n} ranks share "
                f"{len(set(cards))} card(s): run ranks that share a card on a gloo group "
                "(their blocks are staged through host memory)")

    def ring(self, blocks: Sequence[torch.Tensor]) -> "RankRing":
        (block,) = blocks
        return RankRing(block, self)

    def deliver(self, tensors: Sequence[torch.Tensor], device: torch.device
                ) -> tuple[list[torch.Tensor], None]:
        """`LocalExchange.deliver` on a rank, whose tensors are on its own
        device already."""
        return [t.to(device) for t in tensors], None

    def join(self, device: torch.device) -> None:
        """`LocalExchange.join`: a rank holds one card."""

    def all_gather(self, blocks: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
        """lax.all_gather + reshape: every rank's block, in rank order,
        stacked along rows on `device`."""
        (block,) = blocks
        with exchanging():
            if self.backend == "nccl":
                out = block.new_empty((self.n * block.shape[0],) + tuple(block.shape[1:]))
                dist.all_gather_into_tensor(out, block.contiguous(), group=self.group)
                return out.to(device)
            host = block.to("cpu")
            parts = [torch.empty_like(host) for _ in range(self.n)]
            dist.all_gather(parts, host, group=self.group)
            return torch.cat(parts).to(device)

    def psum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """lax.psum: every rank's part, summed in rank order by `psum`."""
        (part,) = parts
        gathered = self.all_gather([part.reshape(1, -1)], part.device)
        return psum([g.reshape(part.shape) for g in gathered])


class RankRing:
    """lax.ppermute forward over the ranks' ring: at step 0 this rank holds
    its own block; each `forward()` sends the held block to rank r + shift
    and receives rank r - shift's into one of two receive buffers, the
    pair issued together; `held(0)` is the block of the current step (on
    the block's device; the current stream waits for its copy to the card
    where it was staged), `done(0)` marks the current stream's reads of
    it issued, and `advance()` moves to the next step. The pair is waited
    on where the next step first needs its block: the next `forward()` or
    `held()`, whichever comes first. RingExchange's interface, with this
    rank's one shard."""

    #: where the held block goes at each step: lax.ppermute's [(i, (i + 1) % P)]
    shift = 1

    def __init__(self, block: torch.Tensor, ex: RankExchange):
        self.ex = ex
        n, r = ex.n, ex.rank
        self.dst, self.src = (r + self.shift) % n, (r - self.shift) % n
        self.held_block = block
        # what a forward sends: the held block, or its pinned host copy
        self._wire = None if ex.staged else block
        host = dict(device="cpu", pin_memory=True) if ex.staged else {}
        self._recv = [torch.empty_like(block, **host) for _ in range(2)]
        self._card = [torch.empty_like(block) for _ in range(2)] if ex.staged else None
        self._slot = 0                        # the buffer the next forward receives into
        self._pending = None                  # (works, issued at, receive buffer)
        self._arriving = False                # the pending receive is the next held block
        self._ready = None                    # the held block's copy to the card
        self._staged_out: list = [None, None]  # each buffer's last copy to the card
        self._reads = [[], []]                # the card buffers' reads, by the step they were held
        self._reading: list = []

    def held(self, i: int) -> torch.Tensor:
        self._arrive()
        if self._ready is not None:
            torch.cuda.current_stream(self.ex.device).wait_event(self._ready)
        return self.held_block

    def done(self, i: int) -> None:
        if self.ex.device.type == "cuda":
            self._reading.append(_event_now(self.ex.device))

    def forward(self) -> None:
        with exchanging():
            self._arrive()
            if self._wire is None:            # staged, step 0: the own block to the host
                self._wire = self._to_host(self.held_block)
            recv = self._recv[self._slot]
            copied = self._staged_out[self._slot]
            if copied is not None:             # its last block still on its way to the card
                copied.synchronize()
            g = self.ex.group
            ops = [dist.P2POp(dist.isend, self._wire, group=g, group_peer=self.dst),
                   dist.P2POp(dist.irecv, recv, group=g, group_peer=self.src)]
            self._pending = (dist.batch_isend_irecv(ops), time.perf_counter(), recv)

    def advance(self) -> None:
        if self._card is not None and self._ready is not None:
            self._reads[1 - self._slot] = self._reading
        self._reading = []
        self._arriving = True
        self._slot = 1 - self._slot

    def _to_host(self, block: torch.Tensor) -> torch.Tensor:
        """A pinned host copy of a card's block, complete on return: the
        copy stream waits for the block's producer, then the host for the
        copy."""
        out = torch.empty_like(block, device="cpu", pin_memory=True)
        stream = self.ex.copy_stream
        stream.wait_event(_event_now(self.ex.device))
        with torch.cuda.stream(stream):
            out.copy_(block, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        block.record_stream(stream)
        ev.synchronize()
        return out

    def _arrive(self) -> None:
        """Wait for the pending pair; its received block becomes the held
        block (on the card: copied there from its pinned buffer on the copy
        stream, after the last reads of the card buffer it lands in)."""
        if not self._arriving:
            return
        works, issued, recv = self._pending
        t0 = time.perf_counter()
        for w in works:
            w.wait()
        t1 = time.perf_counter()
        times = self.ex.times
        times["pairs"] += 1
        times["wait_s"] += t1 - t0
        times["pair_s"] += t1 - issued
        self._pending, self._arriving = None, False
        self._wire = recv
        if self._card is None:
            self.held_block = recv
            return
        slot = 1 - self._slot                  # the buffer the pair received into
        card, stream = self._card[slot], self.ex.copy_stream
        for ev in self._reads[slot]:
            stream.wait_event(ev)
        with torch.cuda.stream(stream):
            card.copy_(recv, non_blocking=True)
            self._ready = torch.cuda.Event()
            self._ready.record(stream)
        card.record_stream(stream)
        self._staged_out[slot] = self._ready
        self.held_block = card
