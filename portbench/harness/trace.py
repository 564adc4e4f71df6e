"""The traced window: device intervals from torch.profiler, their union,
the idle share and the breakdown.

The idea of idle margins is taken from `src/repro_torch/launch/profile.py`
at commit 3b55c50 (`profile_call`): the profiler keeps only the device
events it places inside its recording window, and a skew between the
card's clock and the host's can drop the first or last kernels, so the
traced window sits between two stretches of idle. Its idle share (one
minus the kernels' summed time over a wall time taken in another run) is
replaced here by the union of the device intervals inside one traced
window: overlapping kernels count once, and window and kernels come from
one trace.

The window is the host span `portbench.window` (a `record_function`
around the timed calls and the synchronize that ends them). A device
interval is a kernel, a memcpy or a memset; each is clipped to the window.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "portbench.window"


@dataclass
class Trace:
    """One traced window, times in seconds from the window's start."""

    window_s: float
    device: list = field(default_factory=list)   # (name, start, end)
    host: list = field(default_factory=list)     # (name, start, end)
    counts: dict = field(default_factory=dict)   # work done inside the window

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in union(self.device))

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernel_s(self, names) -> float:
        """Summed device time of the kernels whose function name (without
        namespace, template arguments or parameters) is in `names`."""
        names = set(names)
        return sum(e - s for n, s, e in self.device if kernel_name(n) in names)

    def has_kernels(self, names) -> bool:
        names = set(names)
        return any(kernel_name(n) in names for n, _, _ in self.device)

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time: [name, seconds]."""
        by = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle time of the device inside the window, summed by what the
        host was doing at each gap's middle (the innermost host event
        there): [name, seconds], the largest first."""
        gaps, t = [], 0.0
        for s, e in union(self.device):
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.window_s:
            gaps.append((t, self.window_s))
        by: dict = {}
        if not gaps:
            return []
        g = np.asarray(gaps)
        mids = g.mean(1)
        names = [h[0] for h in self.host] + ["host code outside any recorded op"]
        hs = np.asarray([h[1] for h in self.host] + [-np.inf])
        he = np.asarray([h[2] for h in self.host] + [np.inf])
        dur = he - hs
        dur[-1] = np.finfo(np.float64).max   # the catch-all covers every gap, last
        for i in range(0, len(mids), 256):
            mid = mids[i:i + 256, None]
            covers = (hs[None] <= mid) & (he[None] >= mid)
            inner = np.where(covers, dur[None], np.inf).argmin(1)
            for j, k in enumerate(inner):
                s, e = g[i + j]
                by[names[k]] = by.get(names[k], 0.0) + float(e - s)
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:top]]


def union(intervals) -> list:
    """The union of (.., start, end) intervals as sorted disjoint (start,
    end) pairs."""
    spans = sorted((i[-2], i[-1]) for i in intervals)
    out: list = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def kernel_name(name: str) -> str:
    """`void (anonymous namespace)::foo_kernel<64, float>(float const*)` ->
    `foo_kernel`: the function's name without its return type, namespaces,
    template arguments or parameters."""
    s = name.replace("(anonymous namespace)::", "").strip()
    s = re.sub(r"^void\s+", "", s)
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s.rsplit("::", 1)[-1].strip()


def from_chrome(path, counts: dict) -> Trace:
    """The Trace of the `portbench.window` span in a Chrome trace written by
    `torch.profiler.profile.export_chrome_trace`."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return from_events(events, counts)


def from_events(events: list, counts: dict) -> Trace:
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} '{WINDOW}' host spans, not 1")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])

    def clipped(cats):
        out = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in cats:
                continue
            s = max(float(e["ts"]), w0)
            t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
            if t > s:
                out.append((e["name"], (s - w0) * 1e-6, (t - w0) * 1e-6))
        return out

    # the window's span and the profiler's step spans enclose everything:
    # a gap inside nothing else is host code the profiler does not record
    host = [h for h in clipped(HOST_CATS)
            if h[0] != WINDOW and not h[0].startswith("ProfilerStep")]
    return Trace(window_s=(w1 - w0) * 1e-6, device=clipped(DEVICE_CATS),
                 host=host, counts=dict(counts))
