"""One run of one cell: set-up, the measured or traced window, the check
against the plain reference, and the result line.

A driver (`drivers/<name>.py`, named by the traffic mix) owns what is
particular to a kind of work. Its `Driver(config, traffic, seed, device,
spans)` makes the inputs from the seed, builds the program, drives it
through the steps the check follows and warms up every shape the window
uses; `step()` does one unit of the window's work and adds to `counts`;
`release()` frees the program's state; `check()` runs the reference and
returns the numbers compared, by name. The harness times the rest.
"""
from __future__ import annotations

import contextlib
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench.harness import spec
from portbench.harness import trace as tracing

#: the packages no run may hold once its window has closed: JAX and the
#: JAX package this port was made from, compared by whole top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: idle kept before and after the traced window
TRACE_MARGIN_S = 0.2
#: the traced window's length at most: some tens of steps, a trace that
#: reads in seconds
TRACE_WINDOW_S = 4.0


class NoCard(RuntimeError):
    """The run needs more CUDA devices than this machine shows."""


@dataclass
class Record:
    """What a metric's reader reads. Times in seconds."""

    setup_s: float
    window_s: float | None = None
    counts: dict = field(default_factory=dict)     # work done in the window
    spans: dict = field(default_factory=dict)      # host spans of set-up
    sizes: dict = field(default_factory=dict)      # the inputs' sizes
    program: dict = field(default_factory=dict)    # the program's own counters
    trace: tracing.Trace | None = None


class Spans(dict):
    """Host-clock spans by name, in seconds: `with spans("name"): ...`."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        sync(self.device)
        t = time.perf_counter()
        yield
        sync(self.device)
        self[name] = self.get(name, 0.0) + time.perf_counter() - t


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def forbidden_modules() -> list[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card_lines(chips: int) -> list[str]:
    """The card's name, the device count and the power limit."""
    lines = [f"device {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}; "
             f"used {chips}"]
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"not read ({e.__class__.__name__})"
    lines.append(f"nvidia-smi name, power limit: {out}")
    return lines


def _window(drv, seconds: float, device) -> tuple[float, dict]:
    """Drive `drv.step()` from now until `seconds` have passed; the window
    ends at a synchronize after the last step that began inside it."""
    before = dict(drv.counts)
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        drv.step()
    sync(device)
    window = time.perf_counter() - t
    return window, {k: v - before.get(k, 0) for k, v in drv.counts.items()}


def _traced_window(drv, seconds: float, device) -> tracing.Trace:
    """One step outside the record (the profiler's warm-up step), then the
    window under torch.profiler between two idle margins."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
    os.close(fd)
    counts: dict = {}
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            drv.step()
            sync(device)
            prof.step()
            time.sleep(TRACE_MARGIN_S)
            with record_function(tracing.WINDOW):
                _, counts = _window(drv, seconds, device)
            time.sleep(TRACE_MARGIN_S)
            prof.step()
        return tracing.from_chrome(path, counts)
    finally:
        os.unlink(path)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", root: Path = spec.ROOT, t0: float | None = None,
        log=print) -> dict:
    """One run; returns the result line as a dict. `device="cpu"` is the
    CPU rehearsal of the tests: it reports no device metric."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.cell(workload, root)
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoCard(f"{workload} needs {cell.chips} CUDA device(s); "
                         f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                         f"device_count() is {torch.cuda.device_count()}")
    elif trace:
        raise ValueError("device metrics are read from the card's trace; "
                         "a CPU run reports none")
    spans = Spans(device)
    t_driver = time.perf_counter()
    drv = spec.driver(cell.traffic, root).Driver(cell.config, cell.traffic, seed,
                                                 device, spans)
    sync(device)
    rec = Record(setup_s=time.perf_counter() - t0, spans=dict(spans),
                 sizes=dict(drv.sizes), program=dict(drv.program))
    log(f"setup {rec.setup_s:.3f} s: {t_driver - t0:.3f} s before the driver; "
        + ", ".join(f"{k} {v:.3f} s" for k, v in spans.items()))
    if trace:
        rec.trace = _traced_window(drv, min(seconds, TRACE_WINDOW_S), device)
        if rec.trace.busy_s <= 0:
            raise RuntimeError("the profiler recorded no device time in the window")
        rec.counts = dict(rec.trace.counts)
    else:
        rec.window_s, rec.counts = _window(drv, seconds, device)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        # after the window: nvidia-smi's start-up is no part of set-up
        for line in card_lines(cell.chips):
            log(line)
    attempted = int(rec.counts.get(drv.unit, 0))
    drv.release()

    t_check = time.perf_counter()
    numbers = drv.check()
    log(f"check {time.perf_counter() - t_check:.3f} s")
    checks, correct = {}, bool(numbers) and drv.failed == 0
    for name, value in numbers.items():
        limit = cell.limits.get(name)
        ok = limit is not None and math.isfinite(value) and value <= limit
        correct &= ok
        checks[name] = {"value": value, "limit": limit}
    for name in cell.limits:
        if name not in numbers:
            correct = False
            checks[name] = {"value": None, "limit": cell.limits[name]}

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"], root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the process holds {found} once the window has closed")
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": int(drv.failed), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    result["checks"] = checks
    return result
