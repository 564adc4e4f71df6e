"""The port's spans (`repro_torch/spans.py`) on the CPU.

  * Off (no profiler recording): `span` is one shared null context, enters
    no `record_function`, records no CUDA event and keeps no record, through
    a sweep and a top-N call.
  * Under `torch.profiler.profile(schedule(wait=0, warmup=1, active=1))`:
    the warm-up step's spans are not kept, the active step's are, on a
    second thread too; they are `user_annotation` events of the exported
    Chrome trace, each inside its parent.
  * One sweep records `gibbs.sweep` over two `gibbs.assemble` and two
    `gibbs.solve`; one `recommend` records `topn.serve` over `topn.upload`,
    `topn.score`, `topn.fetch` and `topn.finish`, the exclusion inside
    `topn.finish`. The sweep's state and the lists are bit for bit those of
    an unprofiled call.
  * `totals()` sums each span's stream time between its two events (a fake
    card's events stand in for the card's).

Data: `synthetic_lowrank(60, 40, k_true=4, nnz=900)`, K = 8; draws of 30
users and 50 items at K = 4, three draws.
"""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile, schedule  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.core import GibbsSampler  # noqa: E402
from repro_torch.data.datasets import synthetic_lowrank  # noqa: E402
from repro_torch.serve import PosteriorEnsemble, TopNRecommender  # noqa: E402
from repro_torch.serve.topn import SeenIndex  # noqa: E402

CPU = torch.device("cpu")
SWEEP = {"gibbs.sweep": 1, "gibbs.assemble": 2, "gibbs.solve": 2}
SERVE = ("topn.upload", "topn.score", "topn.fetch", "topn.finish")


@pytest.fixture(autouse=True)
def fresh():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture(scope="module")
def ratings():
    r, _, _ = synthetic_lowrank(60, 40, k_true=4, nnz=900, seed=2)
    return r


def _sampler(ratings):
    return GibbsSampler(ratings, k=8, alpha=2.0, burn_in=0, widths=(4, 16, 64),
                        device=CPU)


def _recommender():
    rng = np.random.default_rng(7)
    s, m, n, k = 3, 30, 50, 4
    ens = PosteriorEnsemble.from_arrays(
        rng.normal(size=(s, m, k)).astype(np.float32),
        rng.normal(size=(s, n, k)).astype(np.float32),
        hyper_u_mu=np.zeros((s, k), np.float32),
        hyper_u_lam=np.broadcast_to(np.eye(k, dtype=np.float32), (s, k, k)),
        hyper_v_mu=np.zeros((s, k), np.float32),
        hyper_v_lam=np.broadcast_to(np.eye(k, dtype=np.float32), (s, k, k)),
        global_mean=3.5, alpha=2.0, steps=[1, 2, 3], device=CPU)
    return TopNRecommender(ens, device=CPU)


def _seen():
    from repro_torch.data.sparse import SparseRatings

    rng = np.random.default_rng(3)
    rows = rng.integers(0, 30, 120).astype(np.int32)
    cols = rng.integers(0, 50, 120).astype(np.int32)
    return SeenIndex(SparseRatings(rows, cols, np.ones(120, np.float32), (30, 50)))


def _active(fn, trace=None):
    """fn(step) in the warm-up step (step 0) and the active step (step 1) of
    a profiler schedule; returns the active step's result."""
    out = []
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=(lambda p: p.export_chrome_trace(str(trace)))
                 if trace else None) as prof:
        for step in range(2):
            out.append(fn(step))
            prof.step()
    return out[1]


def test_off_is_one_shared_null_context():
    a, b = spans.span("a"), spans.span("b", CPU)
    assert a is b
    with a:
        pass
    assert spans.totals() == {} and spans.records() == []


def test_off_enters_no_record_function_and_records_no_event(ratings, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("span entered profiler or device work while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    s = _sampler(ratings)
    s.sweep(s.init(0))
    rec = _recommender()
    rec.recommend(np.arange(10), 5)
    rec.recommend(np.arange(10), 5, seen=_seen())
    with spans.span("x", torch.device("cuda")):
        pass
    assert spans.totals() == {}


def test_warmup_step_not_kept_active_step_kept_in_the_trace(tmp_path):
    def body(step):
        with spans.span(f"outer{step}"):
            with spans.span(f"inner{step}"):
                pass

    path = tmp_path / "trace.json"
    _active(body, path)
    recs = spans.records()
    assert [r.name for r in recs] == ["inner1", "outer1"]
    inner, outer = recs
    assert inner.parent == "outer1" and outer.parent is None and inner.root == outer.root
    assert outer.host_start <= inner.host_start <= inner.host_end <= outer.host_end
    assert inner.start is None and inner.end is None
    tot = spans.totals()
    assert set(tot) == {"inner1", "outer1"}
    assert tot["outer1"]["calls"] == 1 and tot["outer1"]["device_s"] is None
    assert tot["outer1"]["host_s"] >= tot["inner1"]["host_s"] >= 0
    events = json.loads(path.read_text())["traceEvents"]
    ann = {e["name"]: e for e in events
           if e.get("cat") == "user_annotation" and e.get("ph") == "X"}
    assert {"inner1", "outer1"} <= set(ann) and not {"inner0", "outer0"} & set(ann)
    o, i = ann["outer1"], ann["inner1"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]


def test_span_on_a_second_thread_is_recorded():
    def body(step):
        def work():
            with spans.span(f"thread{step}"):
                pass

        with spans.span(f"main{step}"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()

    _active(body)
    recs = {r.name: r for r in spans.records()}
    assert set(recs) == {"thread1", "main1"}
    # the thread's span is its own outermost one
    assert recs["thread1"].parent is None and recs["thread1"].root != recs["main1"].root


def test_sweep_spans(ratings):
    s = _sampler(ratings)
    st = s.init(0)
    _active(lambda step: s.sweep(st))
    tot = spans.totals()
    assert {n: t["calls"] for n, t in tot.items()} == SWEEP
    recs = spans.records()
    sweep = next(r for r in recs if r.name == "gibbs.sweep")
    for r in recs:
        assert r.root == sweep.root
        if r is not sweep:
            assert r.parent == "gibbs.sweep"
            assert sweep.host_start <= r.host_start <= r.host_end <= sweep.host_end
    assert tot["gibbs.sweep"]["host_s"] >= tot["gibbs.assemble"]["host_s"] + \
        tot["gibbs.solve"]["host_s"]


@pytest.mark.parametrize("seen", [False, True])
def test_serve_spans(seen, monkeypatch):
    rec = _recommender()
    index = _seen() if seen else None
    isin_in = []
    isin = np.isin

    def spied(*args, **kwargs):
        isin_in.append(spans._local.stack[-1][0] if getattr(spans._local, "stack", None)
                       else None)
        return isin(*args, **kwargs)

    monkeypatch.setattr(np, "isin", spied)
    _active(lambda step: rec.recommend(np.arange(12), 5, seen=index))
    recs = spans.records()
    assert sorted(r.name for r in recs) == sorted(SERVE + ("topn.serve",))
    serve = next(r for r in recs if r.name == "topn.serve")
    assert all(r.parent == "topn.serve" and r.root == serve.root
               for r in recs if r is not serve)
    # the children in order, each inside topn.serve
    children = sorted((r for r in recs if r is not serve), key=lambda r: r.host_start)
    assert tuple(r.name for r in children) == SERVE
    assert serve.host_start <= children[0].host_start
    assert children[-1].host_end <= serve.host_end
    # the exclusion runs inside topn.finish, once a row, and only with
    # `seen` (the warm-up step's rows run under no span)
    assert isin_in == ([None] * 12 + ["topn.finish"] * 12 if seen else [])


def test_results_bit_for_bit_with_and_without_the_profiler(ratings):
    s = _sampler(ratings)
    st = s.init(3)
    noise = s.draw_noise()
    plain = s.sweep(st, noise)
    traced = _active(lambda step: s.sweep(st, noise))
    for a, b in ((plain.u, traced.u), (plain.v, traced.v),
                 (plain.hyper_u.mu, traced.hyper_u.mu), (plain.hyper_u.lam, traced.hyper_u.lam),
                 (plain.hyper_v.mu, traced.hyper_v.mu), (plain.hyper_v.lam, traced.hyper_v.lam),
                 (plain.pred_sum, traced.pred_sum)):
        assert torch.equal(a, b)
    rec, index = _recommender(), _seen()
    ids = np.arange(30)
    for kw in ({}, {"seen": index}):
        want = rec.recommend(ids, 7, **kw)
        got = _active(lambda step: rec.recommend(ids, 7, **kw))
        assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])
        assert want[0].dtype == got[0].dtype and want[1].dtype == got[1].dtype


class _FakeEvent:
    """A card's timing event on a made-up stream clock."""

    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        _FakeEvent.clock += 2.5
        self.t = _FakeEvent.clock

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, end):
        return end.t - self.t   # ms


def test_totals_sum_the_stream_time_between_each_spans_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    card = torch.device("cuda", 0)

    def body(step):
        for _ in range(3):
            with spans.span("outer", card):
                with spans.span("inner", card):
                    pass
        with spans.span("host_only"):
            pass

    _active(body)
    tot = spans.totals()
    # each event ticks the fake clock 2.5 ms: inner spans 1 tick, outer 3
    assert tot["inner"]["calls"] == 3 and tot["inner"]["device_s"] == pytest.approx(3 * 2.5e-3)
    assert tot["outer"]["device_s"] == pytest.approx(3 * 7.5e-3)
    assert tot["host_only"]["device_s"] is None
    spans.reset()
    assert spans.totals() == {}


# ---------------------------------------------------------------------------
# the distributed sweep's spans, and the card a span timed
# ---------------------------------------------------------------------------
P = 4
#: an async sweep's spans over P shards: P ring steps of 2 blocks a shard,
#: P - 1 forwards of 2 rings a shard, 2 solves a shard, 2 hyper draws
DIST = {"dist.sweep": 1, "dist.stats": 2, "dist.accumulate": 2 * P * P,
        "dist.wait": 2 * P * P, "dist.exchange": 2 * (P - 1) * P, "dist.solve": 2 * P}


def _dist(ratings, mode="async"):
    from repro_torch.core.distributed import DistributedBPMF

    return DistributedBPMF(ratings, devices=[CPU] * P, k=8, alpha=2.0, width="auto",
                           mode=mode, engine="fused")


def test_off_dist_sweep_enters_no_record_function_and_records_no_event(ratings,
                                                                       monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("span entered profiler or device work while off")

    d = _dist(ratings)
    st = d.init(0)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    d.sweep(st)
    assert spans.totals() == {} and spans.totals_by_card() == {}


@pytest.mark.parametrize("mode", ["async", "ring"])
def test_dist_sweep_spans(ratings, mode):
    """Each dist.* span once a call, every one inside the sweep's; in ring
    mode the two half-sweeps' rings come one after the other, with the
    same calls."""
    d = _dist(ratings, mode)
    st = d.init(0)
    noise = d.draw_noise()
    plain = d.sweep(st, noise)
    traced = _active(lambda step: d.sweep(st, noise))
    for a, b in zip(plain.u + plain.v, traced.u + traced.v):
        assert torch.equal(a, b)
    tot = spans.totals()
    assert {n: t["calls"] for n, t in tot.items()} == DIST
    recs = spans.records()
    sweep = next(r for r in recs if r.name == "dist.sweep")
    assert sweep.parent is None
    for r in recs:
        assert r.root == sweep.root and r.card is None
        if r is not sweep:
            assert r.parent == "dist.sweep"
            assert sweep.host_start <= r.host_start <= r.host_end <= sweep.host_end
    # off the card each span has only host time, under the card None
    assert all(set(by) == {None} for by in spans.totals_by_card().values())


def test_span_times_the_stream_given_on_the_card_given(monkeypatch):
    """`span(name, cuda:c, stream=s)` records its events on s and keeps the
    card c; `totals_by_card` splits what `totals` sums."""
    streams = []

    class Event(_FakeEvent):
        def record(self, stream=None):
            streams.append(stream)
            super().record(stream)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: ("current", device))
    cards = [torch.device("cuda", c) for c in (0, 1, 3)]

    def body(step):
        for c in cards:
            with spans.span("dist.exchange", c, stream=("copy", c.index)):
                pass
            with spans.span("dist.wait", c):
                pass
        with spans.span("dist.exchange", cards[1], stream=("copy", 1)):
            pass

    _active(body)
    assert streams == [s for c in cards for s in [("copy", c.index)] * 2
                       + [("current", c)] * 2] + [("copy", 1)] * 2
    assert [r.card for r in spans.records()] == [0, 0, 1, 1, 3, 3, 1]
    by = spans.totals_by_card()
    assert {c: t["calls"] for c, t in by["dist.exchange"].items()} == {0: 1, 1: 2, 3: 1}
    assert {c: t["calls"] for c, t in by["dist.wait"].items()} == {0: 1, 1: 1, 3: 1}
    for name, t in spans.totals().items():
        assert t["calls"] == sum(c["calls"] for c in by[name].values())
        assert t["device_s"] == pytest.approx(sum(c["device_s"] for c in by[name].values()))
        assert t["device_s"] == pytest.approx(t["calls"] * 2.5e-3)
