"""A copy of the benchmark at a size the CPU runs in seconds, for the tests.

`tiny_root(path)` copies BENCHMARK.json and portbench/ (its tests and
caches aside) under `path` and shrinks each configuration's matrix and
rank and the top-N batch; the limits stay the cells' own.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SIZES = {"chembl-k64": (600, 40, 2400), "ml20m-k64": (300, 150, 9000)}
K = 16


def tiny_root(path: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", path / "BENCHMARK.json")
    shutil.copytree(BENCH, path / "portbench",
                    ignore=shutil.ignore_patterns("tests", ".cache", "__pycache__"))
    for name, (m, n, nnz) in SIZES.items():
        f = path / "portbench" / "configs" / f"{name}.json"
        cfg = json.loads(f.read_text())
        cfg["data"].update(n_users=m, n_items=n, nnz=nnz)
        cfg["model"]["k"] = K
        cfg["model"]["prior"]["nu0"] = K
        f.write_text(json.dumps(cfg))
    f = path / "portbench" / "traffic" / "topn_all.json"
    traffic = json.loads(f.read_text())
    traffic["batch"] = 64
    f.write_text(json.dumps(traffic))
    return path
