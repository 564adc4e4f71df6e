"""The collectives of the distributed sampler, for P shards in one process.

The JAX package runs `core/distributed.py` as one program over a mesh of P
devices (shard_map) and exchanges counterpart blocks with lax.ppermute,
lax.all_gather and lax.psum. Here one process holds the P shards, shard
p's tensors on devices[p] (several shards may share a card), and each
collective is a copy or a fixed-order sum between the shards' tensors:

  RingExchange  ppermute p -> p + 1 mod P. Each step's blocks are copied
                on a copy stream of the receiving card into one of two
                receive buffers a shard, after the event where the block
                was produced and after the last reads of that buffer; the
                accumulate that consumes a block waits on the copy's event.
                The copies of step s + 1 thus run beside the accumulates
                of step s (the "both" region of the paper's Fig 6). On one
                card the copy stands in for the link: it moves the bytes.
  all_gather    the P blocks concatenated on one shard's device.
  psum          a sum over shards 0..P-1 in that order on shard 0's
                device, then a copy to each shard's device.

No atomics: every sum runs in a fixed order, so the exchange modes give
the same bits on every run. On the CPU the copies are plain copies.
"""
from __future__ import annotations

from typing import Sequence

import torch


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
    `copy_streams` maps a card to the stream its copies run on.
    """

    #: where shard p's block goes at each step: lax.ppermute's
    #: [(i, (i + 1) % P)]
    shift = 1

    def __init__(self, blocks: Sequence[torch.Tensor],
                 copy_streams: dict[torch.device, torch.cuda.Stream]):
        self.blocks = list(blocks)
        self.devices = [b.device for b in self.blocks]
        self.copy_streams = copy_streams
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
        ev = self._ready[p]
        if ev is not None:
            torch.cuda.current_stream(self.devices[p]).wait_event(ev)
        return self.blocks[p]

    def done(self, p: int) -> None:
        if self.devices[p].type == "cuda":
            self._reading[p].append(_event_now(self.devices[p]))

    def forward(self) -> None:
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
                nxt[dst] = buf.copy_(block)
                continue
            stream = self.copy_streams[buf.device]
            if made[src] is not None:
                stream.wait_event(made[src])
            for ev in self._reads[dst][slot]:
                stream.wait_event(ev)
            with torch.cuda.stream(stream):
                buf.copy_(block, non_blocking=True)
                ready[dst] = torch.cuda.Event()
                ready[dst].record(stream)
            # the caching allocator must not hand either tensor out again
            # before the copy has run
            buf.record_stream(stream)
            block.record_stream(stream)
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


def all_gather(blocks: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """lax.all_gather + reshape: the P blocks in shard order, stacked along
    rows on `device`."""
    return torch.cat([b.to(device) for b in blocks])


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """lax.psum: the parts summed in shard order on the first part's device."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part.to(total.device)
    return total
