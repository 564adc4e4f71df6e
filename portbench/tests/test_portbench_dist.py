"""The distributed cell `ml20m.dist_async` on the CPU at a tiny size, four
shards on the CPU: the driver against the plain asynchronous sweep
(`reference/bpmf_async.py`) within the cell's limits, two faults that the
check must catch by ten times a limit or more (the program in ring mode,
whose user draw reads the new v; a ring step whose block is left out),
the lower-precision controls, a whole run's result line, and the five
`dist.*` readers on made-up records and on a traced window.

Run with `python -m pytest -q portbench/tests` from the root of the repo.
"""
from __future__ import annotations

import json
import sys

import pytest

from tiny import K, tiny_root

import repro_torch
from portbench.harness import cell, spec
from portbench.harness.trace import Trace
from repro_torch import spans
from repro_torch.core import distributed

CELL = "ml20m.dist_async"
SEED = 5 * 2**31 + 3
#: (users, items, ratings): every shard holds some of each, and the
#: heaviest items rate more than one plan row
SIZE = (300, 150, 9000)
SPANS = ("dist.accumulate_ms", "dist.solve_ms", "dist.exchange_ms",
         "dist.exchange_exposed_ms")


def _shrink(root, **layout):
    f = root / "portbench" / "configs" / "ml20m-k64-p4.json"
    cfg = json.loads(f.read_text())
    m, n, nnz = SIZE
    cfg["data"].update(n_users=m, n_items=n, nnz=nnz)
    cfg["model"]["k"] = K
    cfg["model"]["prior"]["nu0"] = K
    cfg["layout"].update(layout)
    f.write_text(json.dumps(cfg))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _shrink(tiny_root(tmp_path_factory.mktemp("bench")))


def _driver(root, seconds=0.2):
    c = spec.cell(CELL, root)
    drv = spec.driver(c.traffic, root).Driver(c.config, c.traffic, SEED, "cpu",
                                              cell.Spans("cpu"))
    cell._window(drv, seconds, "cpu")
    return c, drv


def _worst(numbers: dict, limits: dict) -> float:
    """The largest reading over its limit."""
    return max(numbers[n] / lim for n, lim in limits.items())


def test_cell_shape(root):
    c = spec.cell(CELL, root)
    assert c.chips == 4 and c.traffic["driver"] == "dist"
    assert c.config["layout"]["mode"] == "async" and c.config["layout"]["shards"] == 4
    assert [m["name"] for m in c.end_to_end] == ["updates_per_s", "setup_s"]
    assert {m["name"] for m in c.per_layer} == {"dist.sweep_mfu", *SPANS}
    assert set(c.limits) == {"u", "v", "mu_u", "lam_u", "mu_v", "lam_v"}


def test_driver_passes_its_check(root):
    c, drv = _driver(root)
    assert drv.sampler.mode == "async" and drv.sampler.n_shards == 4
    assert drv.counts["sweeps"] >= 5 and drv.sizes["P"] == 4
    assert sum(drv.sizes["shard_ratings_u"]) == sum(drv.sizes["shard_ratings_v"]) \
        == drv.sizes["nnz"] == drv.program["plan.nnz"] // 2
    numbers = drv.check()
    assert _worst(numbers, c.limits) < 1, numbers
    # four checked states: three set-up sweeps and the window's last
    assert len(drv.outputs()) == 4


def test_ring_in_async_place_fails_the_check(tmp_path):
    """Ring mode's user draw conditions on the NEW v: from the first
    sweep on, its u is another draw (and the chain another chain)."""
    root = _shrink(tiny_root(tmp_path), mode="ring")
    c, drv = _driver(root)
    assert drv.sampler.mode == "ring"
    numbers = drv.check()
    assert numbers["u"] >= 10 * c.limits["u"], numbers


def test_a_skipped_ring_block_fails_the_check(root, monkeypatch):
    """The accumulate of one block of the ring's second step left out, in
    every sweep: its ratings are missing from the shard's systems."""
    real = distributed._accumulate_block
    calls = []

    def skipping(prec, rhs, counter_blk, plan, **kw):
        calls.append(1)
        # in an async sweep's ring: 2 sides x 4 shards a step; this is the
        # movie side of shard 1 at step 1
        if len(calls) % 32 != 10:
            real(prec, rhs, counter_blk, plan, **kw)

    monkeypatch.setattr(distributed, "_accumulate_block", skipping)
    c, drv = _driver(root)
    assert len(calls) % 32 == 0
    assert _worst(drv.check(), c.limits) >= 10


@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_lower_precision_fails(root, precision):
    c, drv = _driver(root)
    drv.release()
    assert _worst(drv.judge(drv.control(precision), drv.reference()), c.limits) > 1


def test_rehearsal_result_line(root):
    r = cell.run(CELL, SEED, 0.3, False, device="cpu", root=root, log=lambda s: None)
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == {"updates_per_s", "setup_s"}
    assert r["attempted"] > 0 and r["failed"] == 0
    json.dumps(r, allow_nan=False)


def test_device_metrics_refused_off_the_card(root):
    with pytest.raises(ValueError, match="card"):
        cell.run(CELL, 1, 0.1, True, device="cpu", root=root)


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------
def read(name, rec):
    return spec.metric_reader(name)(rec)


#: per-card totals of 4 sweeps: accumulate busiest on card 2, solve on 0,
#: exchange on 3, wait on 1
BY_CARD = {
    "dist.sweep": {0: {"calls": 4, "host_s": 0.1, "device_s": 0.4}},
    "dist.accumulate": {c: {"calls": 16, "host_s": 0.01, "device_s": s}
                        for c, s in enumerate((0.10, 0.12, 0.16, 0.08))},
    "dist.solve": {c: {"calls": 8, "host_s": 0.01, "device_s": s}
                   for c, s in enumerate((0.04, 0.03, 0.02, 0.01))},
    "dist.exchange": {c: {"calls": 24, "host_s": 0.01, "device_s": s}
                      for c, s in enumerate((0.002, 0.001, 0.003, 0.006))},
    "dist.wait": {c: {"calls": 32, "host_s": 0.01, "device_s": s}
                  for c, s in enumerate((0.0004, 0.0008, 0.0, 0.0))},
}
WANT = {"dist.accumulate_ms": 40.0, "dist.solve_ms": 10.0, "dist.exchange_ms": 1.5,
        "dist.exchange_exposed_ms": 0.2}


def _rec(sweeps):
    sizes = {"m": 138_493, "n": 27_278, "nnz": 18_000_237, "k": 64, "cards": 4}
    return cell.Record(setup_s=1.0, sizes=sizes,
                       trace=Trace(window_s=2.0, counts={"sweeps": sweeps}))


@pytest.fixture
def by_card(monkeypatch):
    """Puts made-up per-card totals in the program's place."""
    def put(t):
        monkeypatch.setattr(spans, "totals_by_card", lambda: t)
    return put


def test_span_readers_read_the_busiest_card(by_card):
    by_card(BY_CARD)
    assert {n: read(n, _rec(4)) for n in SPANS} == pytest.approx(WANT)


@pytest.mark.parametrize("name", SPANS)
def test_span_readers_none_on_a_count_mismatch_or_off_the_card(by_card, name):
    by_card(BY_CARD)
    assert read(name, _rec(5)) is None
    assert read(name, cell.Record(setup_s=1.0)) is None   # no trace
    by_card({n: {c: dict(t, device_s=None) for c, t in v.items()}
             for n, v in BY_CARD.items()})
    assert read(name, _rec(4)) is None


@pytest.mark.parametrize("name", SPANS)
def test_span_readers_none_without_spans(by_card, monkeypatch, name):
    by_card({})
    assert read(name, _rec(4)) is None
    # a program whose spans keep no card (the parent of this cell)
    monkeypatch.delattr(spans, "totals_by_card")
    assert read(name, _rec(4)) is None
    # a program that has no spans module
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert read(name, _rec(4)) is None


def test_sweep_mfu():
    # 2 sweeps in 2 s: one sweep's work a second over 4 x 67 TFLOP/s
    want = 100.0 * (2 * 2 * 18_000_237 * (2080 + 64) + (138_493 + 27_278)
                    * (64 ** 3 / 3 + 2 * 64 * 64 + 4 * 2080)) / (4 * 67e12)
    assert read("dist.sweep_mfu", _rec(2)) == pytest.approx(want)
    assert read("dist.sweep_mfu", cell.Record(setup_s=1.0)) is None


def test_traced_window_on_the_cpu(root):
    """The harness's traced window around the tiny cell on the CPU: one
    `dist.sweep` a sweep with its children (2 `dist.stats`, 8 `dist.solve`,
    32 `dist.accumulate`, 32 `dist.wait`, 24 `dist.exchange`), none of the
    warm-up step, and no device time for the readers to read."""
    c = spec.cell(CELL, root)
    drv = spec.driver(c.traffic, root).Driver(c.config, c.traffic, 2**33 + 9, "cpu",
                                              cell.Spans("cpu"))
    spans.reset()
    try:
        trace = cell._traced_window(drv, 0.3, "cpu")
        tot = spans.totals_by_card()
    finally:
        drv.release()
        spans.reset()
    n = trace.counts["sweeps"]
    assert n > 0
    calls = {name: sum(t["calls"] for t in by.values()) for name, by in tot.items()}
    assert calls == {"dist.sweep": n, "dist.stats": 2 * n, "dist.solve": 8 * n,
                     "dist.accumulate": 32 * n, "dist.wait": 32 * n, "dist.exchange": 24 * n}
    assert all(set(by) == {None} for by in tot.values())
    rec = cell.Record(setup_s=1.0, trace=trace, sizes=drv.sizes)
    assert [read(name, rec) for name in SPANS] == [None] * 4
