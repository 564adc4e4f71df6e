"""The benchmark's description, and the files it names.

`BENCHMARK.json` at the root of the checkout names every cell
(`workloads`), configuration and metric. Everything that belongs to one of
them sits in a file of its own, found by its name:

  configs/<config>.json      a configuration (its `file` in BENCHMARK.json)
  traffic/<traffic>.json     a traffic mix: parameters, and the `driver`
                             that runs it
  drivers/<driver>.py        the code that drives one kind of work
  metrics/<metric>.py        one metric's reader, `read(record)`
  limits/<workload>.json     the limit of each number the cell compares

so a cell, a configuration, a mix or a metric is added by adding files.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parents[1]   # portbench/
ROOT = BENCH.parent                           # the checkout


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: tuple[dict, ...]   # the metrics a --trace 0 run reports
    per_layer: tuple[dict, ...]    # the metrics a --trace 1 run reports
    limits: dict


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reported(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its files loaded."""
    spec = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = load_json(root / configs[w["config"]]["file"])
    bench = root / "portbench"
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    e2e = tuple(m for m in spec["end_to_end"] if _reported(m, name))
    # a per-layer metric without `workloads` goes wherever its end-to-end
    # metric is reported
    e2e_names = {m["name"] for m in e2e}
    per_layer = tuple(m for m in spec["per_layer"]
                      if (name in m["workloads"] if "workloads" in m
                          else m["moves"] in e2e_names))
    limits_file = bench / "limits" / f"{name}.json"
    limits = load_json(limits_file) if limits_file.exists() else {}
    return Cell(name=name, config=cfg, traffic=traffic, chips=int(w["chips"]),
                end_to_end=e2e, per_layer=per_layer, limits=limits)


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(traffic: dict, root: Path = ROOT) -> ModuleType:
    """The module that runs a traffic mix: drivers/<traffic['driver']>.py."""
    name = traffic["driver"]
    return _module(root / "portbench" / "drivers" / f"{name}.py", f"portbench_driver_{name}")


def metric_reader(name: str, root: Path = ROOT):
    """`read(record) -> float | None` of metrics/<name>.py."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    return _module(path, "portbench_metric_" + name.replace(".", "_")).read
