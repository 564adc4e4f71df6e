"""The readers of the program's spans: `gibbs.assemble_ms`,
`gibbs.solve_ms`, `gibbs.sweep_self_ms` (from `repro_torch.spans.totals()`)
and `topn.program_idle_share` (from the `topn.serve` spans of the trace),
on made-up totals and traces, and on a traced window of the tiny cells on
the CPU, where the spans have no device time.

Run with `python -m pytest portbench/tests` from the root of the repo.
"""
from __future__ import annotations

import sys

import numpy as np
import pytest

from tiny import tiny_root

import repro_torch
from portbench.harness import cell, spec
from portbench.harness.trace import Trace
from repro_torch import spans

TRAIN = ("gibbs.assemble_ms", "gibbs.solve_ms", "gibbs.sweep_self_ms")
IDLE = "topn.program_idle_share"
TOTALS = {"gibbs.sweep": {"calls": 4, "host_s": 0.2, "device_s": 0.4},
          "gibbs.assemble": {"calls": 8, "host_s": 0.05, "device_s": 0.1},
          "gibbs.solve": {"calls": 8, "host_s": 0.05, "device_s": 0.25}}


def read(name, rec):
    return spec.metric_reader(name)(rec)


def _train_rec(sweeps):
    return cell.Record(setup_s=1.0, trace=Trace(window_s=1.0, counts={"sweeps": sweeps}))


@pytest.fixture
def totals(monkeypatch):
    """Puts made-up totals in the program's place."""
    def put(t):
        monkeypatch.setattr(spans, "totals", lambda: t)
    return put


def test_train_readers_per_sweep(totals):
    totals(TOTALS)
    got = {n: read(n, _train_rec(4)) for n in TRAIN}
    assert got["gibbs.assemble_ms"] == pytest.approx(25.0)
    assert got["gibbs.solve_ms"] == pytest.approx(62.5)
    assert got["gibbs.sweep_self_ms"] == pytest.approx(12.5)


@pytest.mark.parametrize("name", TRAIN)
def test_train_readers_none_on_a_count_mismatch(totals, name):
    totals(TOTALS)
    assert read(name, _train_rec(5)) is None


@pytest.mark.parametrize("name", TRAIN)
def test_train_readers_none_off_the_card(totals, name):
    totals({n: dict(v, device_s=None) for n, v in TOTALS.items()})
    assert read(name, _train_rec(4)) is None
    totals(TOTALS)
    assert read(name, cell.Record(setup_s=1.0)) is None   # no trace


@pytest.mark.parametrize("name", TRAIN)
def test_train_readers_none_without_spans(totals, monkeypatch, name):
    totals({})
    assert read(name, _train_rec(4)) is None
    # a program that has no spans module (the parent of the spans)
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert read(name, _train_rec(4)) is None


def test_program_idle_inside_and_outside_serve():
    # device busy [0, 2], [3, 5], [8, 9] of 10 s: idle [2, 3], [5, 8], [9, 10]
    t = Trace(window_s=10.0, device=[("k", 0.0, 2.0), ("k", 3.0, 5.0), ("c", 8.0, 9.0)],
              host=[("topn.serve", 1.0, 4.0), ("other", 5.0, 6.0),
                    ("topn.serve", 6.0, 9.5), ("topn.score", 6.5, 7.0)])
    rec = cell.Record(setup_s=1.0, trace=t)
    # inside serve: [2, 3] whole; of [5, 8] only [6, 8] (a gap the span
    # covers in part); [9, 9.5] of [9, 10]
    assert read(IDLE, rec) == pytest.approx(35.0)
    assert read(IDLE, rec) <= 100.0 * t.idle_share == pytest.approx(50.0)


def test_program_idle_none_without_serve_spans():
    t = Trace(window_s=1.0, device=[("k", 0.0, 0.5)], host=[("aten::index", 0.6, 0.7)])
    assert read(IDLE, cell.Record(setup_s=1.0, trace=t)) is None
    assert read(IDLE, cell.Record(setup_s=1.0)) is None


def test_program_idle_matches_a_fine_grid():
    """Random device intervals and overlapping serve spans (two threads'
    spans may overlap) against a count on a grid of 1 ms cells."""
    rng = np.random.default_rng(11)
    for _ in range(20):
        edges = np.sort(rng.integers(0, 1000, 40)) / 1000.0
        device = [("k", s, e) for s, e in edges.reshape(-1, 2)[rng.random(20) < 0.7]]
        starts = rng.integers(0, 990, 12)
        host = [("topn.serve", s / 1000.0, (s + rng.integers(1, 200)) / 1000.0)
                for s in starts]
        grid = (np.arange(1000) + 0.5) / 1000.0
        busy = np.zeros(1000, bool)
        inside = np.zeros(1000, bool)
        for _, s, e in device:
            busy |= (grid > s) & (grid < e)
        for _, s, e in host:
            inside |= (grid > s) & (grid < min(e, 1.0))
        want = 100.0 * (inside & ~busy).sum() / 1000.0
        t = Trace(window_s=1.0, device=device, host=[(n, s, min(e, 1.0)) for n, s, e in host])
        assert read(IDLE, cell.Record(setup_s=1.0, trace=t)) == pytest.approx(want, abs=1e-9)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", ["ml20m.train", "ml20m.topn"])
def test_traced_window_on_the_cpu(root, workload):
    """The harness's traced window around the tiny cells on the CPU: the
    program's spans are recorded there (one `gibbs.sweep` a sweep, one
    `topn.serve` a batch, none of the warm-up step), the `topn.serve` spans
    are host events of the trace, and the train readers read nothing, since
    the CPU has no device time."""
    c = spec.cell(workload, root)
    drv = spec.driver(c.traffic, root).Driver(c.config, c.traffic, 2**33 + 7, "cpu",
                                              cell.Spans("cpu"))
    spans.reset()
    try:
        trace = cell._traced_window(drv, 0.3, "cpu")
        tot = spans.totals()
    finally:
        drv.release()
        spans.reset()
    rec = cell.Record(setup_s=1.0, trace=trace)
    if workload == "ml20m.train":
        assert tot["gibbs.sweep"]["calls"] == trace.counts["sweeps"] > 0
        assert tot["gibbs.assemble"]["calls"] == tot["gibbs.solve"]["calls"] \
            == 2 * trace.counts["sweeps"]
        assert tot["gibbs.sweep"]["device_s"] is None
        assert [read(n, rec) for n in TRAIN] == [None] * 3
    else:
        n = trace.counts["batches"]
        assert tot["topn.serve"]["calls"] == n > 0
        assert sum(h[0] == "topn.serve" for h in trace.host) == n
        # no device intervals on the CPU: the serve spans' share of the window
        want = 100.0 * sum(e - s for name, s, e in trace.host
                           if name == "topn.serve") / trace.window_s
        assert read(IDLE, rec) == pytest.approx(want)
