"""The harness on the CPU: each traffic mix's plumbing end to end at a tiny
size, the result line's keys, device metrics refused off the card, and a
cell, configuration, traffic mix and metric added as files alone.

Run with `python -m pytest portbench/tests` from the root of the repo.
"""
from __future__ import annotations

import json

import pytest
import torch

from tiny import tiny_root

from portbench.harness import cell, spec

WORKLOADS = ("chembl.train", "ml20m.train", "ml20m.topn")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device metrics come from the card's trace")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_rehearsal_result_line(root, workload):
    r = cell.run(workload, 2**33 + 11, 0.3, False, device="cpu", root=root, log=lambda s: None)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    c = spec.cell(workload, root)
    assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}
    for name, m in r["metrics"].items():
        assert m["value"] > 0 and m["unit"]
    assert r["device"]["platform"] == "cpu"
    for name, chk in r["checks"].items():
        assert chk["value"] <= chk["limit"], name
    json.dumps(r, allow_nan=False)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_device_metrics_refused_off_the_card(root, workload):
    with pytest.raises(ValueError, match="card"):
        cell.run(workload, 1, 0.1, True, device="cpu", root=root)


def test_no_card_no_result(root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(cell.NoCard):
        cell.run("ml20m.topn", 1, 0.1, False, device="cuda", root=root)


def test_forbidden_modules_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", types.ModuleType("x"))
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert cell.forbidden_modules() == ["repro"]


def test_same_seed_same_inputs(root):
    a = cell.run("ml20m.topn", 77, 0.2, False, device="cpu", root=root, log=lambda s: None)
    b = cell.run("ml20m.topn", 77, 0.2, False, device="cpu", root=root, log=lambda s: None)
    assert a["checks"] == b["checks"]


def test_added_as_files(root):
    """A new configuration, traffic mix and per-layer metric, and a cell
    over them, added as files: the harness finds each by its name."""
    bench = root / "portbench"
    cfg = json.loads((bench / "configs" / "ml20m-k64.json").read_text())
    cfg["name"] = "dummy-k16"
    cfg["data"].update(n_users=200, n_items=90)
    (bench / "configs" / "dummy-k16.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "topn_small.json").write_text(json.dumps(
        {"driver": "topn", "batch": 32, "topk": 5, "sample_share": 1.0}))
    (bench / "metrics" / "dummy.batches.py").write_text(
        "def read(rec):\n    return rec.counts.get('batches')\n")
    (bench / "limits" / "dummy.topn.json").write_text(
        (bench / "limits" / "ml20m.topn.json").read_text())
    spec_file = root / "BENCHMARK.json"
    saved = spec_file.read_text()
    b = json.loads(saved)
    b["configs"].append({"name": "dummy-k16", "source": "test", "file":
                         "portbench/configs/dummy-k16.json", "reduced": [], "why": "test"})
    b["workloads"].append({"name": "dummy.topn", "config": "dummy-k16",
                           "traffic": "topn_small", "chips": 1, "why": "test"})
    b["end_to_end"].append({"name": "dummy.batches", "unit": "batches", "better": "higher",
                            "bound": 0.25, "source": "host_clock",
                            "workloads": ["dummy.topn"]})
    spec_file.write_text(json.dumps(b))
    try:
        r = cell.run("dummy.topn", 5, 0.2, False, device="cpu", root=root, log=lambda s: None)
    finally:
        spec_file.write_text(saved)
    assert r["correct"] is True, r["checks"]
    assert r["metrics"]["dummy.batches"]["value"] > 0
    assert "setup_s" in r["metrics"] and "recs_per_s" not in r["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run_on_the_card(root, card, workload):
    r = cell.run(workload, 2**31 + 5, 1.0, True, device="cuda", root=root, log=lambda s: None)
    assert r["correct"] is True, r["checks"]
    dev = r["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    for name, m in r["metrics"].items():
        assert m["value"] >= 0, name
    assert len(r["breakdown"]["device_ops"]) <= 10
