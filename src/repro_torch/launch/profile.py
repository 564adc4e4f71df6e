"""Measurement helpers of the port on the card: CUDA-event timing and the
profiler's device-busy time of one call.

`chip_smoke.py` times its kernels and profiles its paths with these, and a
benchmark imports them rather than copying them. Both need a CUDA card:
they measure the device and have no CPU fallback.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable

import torch

#: idle before and after the recorded call (`profile_call`)
PROFILE_MARGIN_S = 0.2


def cuda_ms(fn: Callable, reps: int = 5, *, warmup: bool = True) -> float:
    """Mean device time of fn over reps calls after one warm-up call, by
    CUDA events on the current stream. warmup=False times a plain version
    that runs for seconds once, cold: its first call's set-up is noise."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@dataclasses.dataclass
class Profile:
    """The device events of one profiled call, one per kernel name (each
    with its launch count, `count`, and `device_time_total` in us)."""

    events: list
    attempts: int

    @property
    def busy_ms(self) -> float:
        return sum(e.device_time_total for e in self.events) / 1e3

    @property
    def kernels(self) -> int:
        return sum(e.count for e in self.events)


def profile_call(fn: Callable, *, complete: Callable = bool,
                 activities=("cpu", "cuda"), trace: Path | None = None,
                 on_retry: Callable[[list], None] | None = None) -> Profile:
    """Device time by kernel of one call of fn under torch.profiler.

    fn runs twice: once as the profiler's warm-up step, unrecorded, then
    recorded. Recorded from the start, a profiler session after the first
    in a process can miss the first kernel its window launches (on the
    H100: top-N's score kernel, one of a sweep's). `trace` names a file for
    the recorded call's timeline (a Chrome trace).

    The profiler has dropped a trace's device events on the H100 now and
    then: all of a top-N call's or part of one (1 of 2 kernels, 9 of 12),
    or part of a sweep's (364 of 397 kernels; a ring sweep's 652 of 760).
    It keeps only device events that it places inside its recording
    window, and a skew between the card's clock and the host's can place
    the call's first or last kernels outside it; so the recorded call sits
    PROFILE_MARGIN_S of idle inside the window at each end. A trace that
    `complete(events)` rejects (by default: one without device time) is
    taken again, up to twice, after `on_retry(events)`. `activities` names
    what the profiler records: ("cuda",) keeps the host's events out of a
    call of hundreds of thousands of launches."""
    from torch.profiler import ProfilerActivity, profile, schedule

    events: list = []
    for attempt in range(3):
        torch.cuda.synchronize()
        traces: list = []

        def ready(p):
            traces.append(p.key_averages())
            if trace is not None:
                p.export_chrome_trace(str(trace))

        with profile(activities=[getattr(ProfilerActivity, a.upper()) for a in activities],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=ready) as prof:
            for recorded in (False, True):
                if recorded:
                    time.sleep(PROFILE_MARGIN_S)
                fn()
                torch.cuda.synchronize()
                if recorded:
                    time.sleep(PROFILE_MARGIN_S)
                prof.step()
        # the step's own span ("ProfilerStep*") is no kernel
        events = [e for e in (traces[0] if traces else [])
                  if getattr(e, "device_time_total", 0) > 0
                  and e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep")]
        if complete(events) or attempt == 2:
            return Profile(events=events, attempts=attempt + 1)
        if on_retry is not None:
            on_retry(events)
    return Profile(events=events, attempts=3)
