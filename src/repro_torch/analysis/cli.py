"""The port's lint CLI: `python -m repro_torch.analysis [paths...]`.

Runs the eight passes (lock discipline, device work under a lock, global
random draws, sums whose order the card does not fix, the ranks'
collectives, TF32, host syncs in loops, the CUDA kernels and their
launchers) over the given files and
directories (default: ``src/repro_torch``, ``tests/test_torch_*.py`` and
``chip_smoke.py`` under ``--root``): every ``.py`` file, and every
``.cu``/``.cuh`` file for ``cuda-float-atomic``. ``--ptxas SOURCE=LOG``
adds the ptxas -v output of one kernel source for ``cuda-spill``. It
applies per-line suppressions and the checked-in baseline, and exits
non-zero on any new finding.

    python -m repro_torch.analysis                          # text output
    python -m repro_torch.analysis --format json            # machine-readable
    python -m repro_torch.analysis --changed-only           # git-diff-scoped
    python -m repro_torch.analysis --out lint-report.json   # JSON artifact
    python -m repro_torch.analysis --write-baseline         # grandfather current
    python -m repro_torch.analysis --list-rules             # rule catalogue
    python -m repro_torch.analysis \\
        --ptxas src/repro_torch/csrc/topn.cu=topn.log       # + cuda-spill

Exit codes: 0 clean (modulo baseline), 1 new findings, 2 usage/parse error.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis import collectives, cuda, locks, loops, rng, sums, syncs, tf32
from repro_torch.analysis.common import (CUDA_SUFFIXES, CudaSource, Finding,
                                         SourceFile, relative)

PASSES = (locks, loops, syncs, rng, sums, collectives, tf32, cuda)

RULE_DOCS = {
    "guarded-field": "read/write of a lock-guarded attribute outside the lock",
    "locked-call": "*_locked method called without holding self._lock",
    "lock-reacquire": "*_locked method re-acquires its own non-reentrant lock",
    "host-sync-in-loop": ".item()/.tolist()/.cpu()/.numpy()/cuda.synchronize() in a "
                         "loop of core/, models/ or kernels/",
    "sync-under-lock": "torch call or device copy/sync while holding a lock",
    "rng-global": "torch draw without generator=, or a seed of the global generator",
    "ordered-sum": "atomic accumulating scatter (index_add_, scatter_add, "
                   "accumulate=True, weighted bincount); the mesh's collectives "
                   "run in one order on every rank (models/layers.py regions)",
    "ppermute-perm": "a send to (rank + d) % n without a receive from (rank - d) % n "
                     "over the same n in its isend/irecv/P2POp set, or a peer not "
                     "taken % n",
    "collective-branch": "a dist.*/funcol.* collective or P2POp on only one arm of an "
                         "if whose test reads the rank (a deadlock)",
    "collective-axis": "a mesh dim in mesh[...], get_group(...), get_local_rank(...) "
                       "or mesh_dim= that no init_device_mesh(..., mesh_dim_names=...) "
                       "of the tree declares",
    "tf32": "allow_tf32 set to other than False, or matmul precision below 'highest'",
    "cuda-float-atomic": "CUDA atomic or PTX red/atom on a target that is not an integer",
    "cuda-launch-guard": "kernel launcher called outside 'with _on_card(...)'",
    "cuda-launch-check": "kernel launcher's error code does not reach build.check",
    "cuda-fallback": "except that swallows, or ref.* not guarded by 'not _on_cuda', "
                     "in kernels/ops.py or kernels/build.py",
    "cuda-spill": "kernel entry with ptxas spill stores or loads (--ptxas logs only)",
}

ALL_RULES = tuple(RULE_DOCS)

DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_*.py", "chip_smoke.py")


def discover(paths: list[Path]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(f for f in p.rglob("*")
                                if f.suffix in (".py", *CUDA_SUFFIXES)))
        elif p.suffix in (".py", *CUDA_SUFFIXES):
            files.append(p)
    return files


def analyze_file(sf: SourceFile | CudaSource, rules: frozenset[str]
                 ) -> list[tuple[Finding, str]]:
    """All unsuppressed findings for one parsed file, paired with their
    baseline keys and sorted by position."""
    out: list[tuple[Finding, str]] = []
    for pass_mod in PASSES:
        if not rules & frozenset(pass_mod.RULES):
            continue
        if isinstance(sf, CudaSource):
            found = pass_mod.run_cuda(sf) if hasattr(pass_mod, "run_cuda") else []
        else:
            found = pass_mod.run(sf)
        for f in found:
            if f.rule not in rules or sf.suppressed(f.line, f.rule):
                continue
            out.append((f, f.baseline_key(sf.source_line(f.line))))
    out.sort(key=lambda fk: fk[0].sort_key())
    return out


def load_source(path: Path, rel: str, text: str) -> SourceFile | CudaSource:
    """A parsed Python file, or a CUDA one by its suffix."""
    kind = CudaSource if path.suffix in CUDA_SUFFIXES else SourceFile
    return kind(path, rel, text)


def analyze_ptxas(logs: dict[str, str], rules: frozenset[str] = frozenset(ALL_RULES),
                  demangle=None) -> list[tuple[Finding, str]]:
    """cuda-spill findings, with their keys, of ptxas logs given by kernel
    source (posix path relative to the root)."""
    if "cuda-spill" not in rules:
        return []
    return [(f, f.baseline_key()) for path, log in sorted(logs.items())
            for f in cuda.spill_findings(log, path, demangle)]


def _parse(paths: list[Path], root: Path, errors: list[str]) -> list:
    out = []
    for path in discover(paths):
        try:
            out.append(load_source(path, relative(path, root), path.read_text()))
        except SyntaxError as e:
            errors.append(f"{path}: {e.msg} (line {e.lineno})")
    return out


def tree_mesh_dims(paths: list[Path], root: Path) -> set[str]:
    """The mesh dims the Python files under `paths` declare (collective-axis
    holds every file to the tree's declarations)."""
    return set().union(*(collectives.declared_dims(sf) for sf in _parse(paths, root, [])
                         if isinstance(sf, SourceFile)))


def analyze_paths(paths: list[Path], root: Path,
                  rules: frozenset[str] = frozenset(ALL_RULES),
                  mesh_dims: set[str] | None = None,
                  ) -> tuple[list[tuple[Finding, str]], list[str]]:
    """(findings-with-keys, parse_errors) over every file under `paths`;
    `mesh_dims` are the mesh dims the tree declares (default: those the
    files under `paths` declare)."""
    findings: list[tuple[Finding, str]] = []
    errors: list[str] = []
    sources = _parse(paths, root, errors)
    if mesh_dims is None:
        mesh_dims = set().union(*(collectives.declared_dims(sf) for sf in sources
                                  if isinstance(sf, SourceFile)))
    for sf in sources:
        sf.mesh_dims = mesh_dims
        findings.extend(analyze_file(sf, rules))
    return findings, errors


def git_changed_files(root: Path) -> set[Path] | None:
    """Files touched vs HEAD (staged + unstaged + untracked), resolved
    absolute; None when git is unavailable / not a repository."""
    out: set[Path] = set()
    for cmd in (["git", "diff", "--name-only", "HEAD"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            res = subprocess.run(cmd, cwd=root, capture_output=True,
                                 text=True, check=True)
        except (OSError, subprocess.CalledProcessError):
            return None
        out.update((root / line).resolve()
                   for line in res.stdout.splitlines() if line.strip())
    return out


def default_paths(root: Path) -> list[Path]:
    out: list[Path] = []
    for pattern in DEFAULT_PATHS:
        out.extend(sorted(root.glob(pattern)) if "*" in pattern else [root / pattern])
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to analyze (default: "
                         f"{' '.join(DEFAULT_PATHS)} under --root)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: <root>/{baseline_mod.DEFAULT_BASELINE} "
                         "when it exists)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="record every current finding as grandfathered and exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset to run")
    ap.add_argument("--changed-only", action="store_true",
                    help="only analyze files changed vs git HEAD "
                         "(staged, unstaged, untracked) — fast pre-commit runs")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write the JSON report to FILE "
                         "(independent of --format)")
    ap.add_argument("--root", default=".",
                    help="paths in output/baseline are relative to this")
    ap.add_argument("--ptxas", action="append", default=[], metavar="SOURCE=LOG",
                    help="ptxas -v output LOG of the kernel source SOURCE (relative "
                         "to --root) for cuda-spill; repeatable")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, doc in RULE_DOCS.items():
            print(f"{rule:18s} {doc}")
        return 0

    rules = frozenset(ALL_RULES)
    if args.rules:
        rules = frozenset(r.strip() for r in args.rules.split(",") if r.strip())
        unknown = rules - frozenset(ALL_RULES)
        if unknown:
            print(f"unknown rules: {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2

    root = Path(args.root)
    paths = [Path(p) for p in args.paths] if args.paths else default_paths(root)
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(f"no such path: {', '.join(map(str, missing))}", file=sys.stderr)
        return 2
    logs: dict[str, str] = {}
    for spec in args.ptxas:
        source, _, log = spec.rpartition("=")
        if not Path(log).is_file():
            print(f"no such ptxas log: {log}", file=sys.stderr)
            return 2
        logs[source or log] = Path(log).read_text()

    mesh_dims = tree_mesh_dims(paths, root)
    if args.changed_only:
        changed = git_changed_files(root)
        if changed is None:
            print("--changed-only: git unavailable or not a repository",
                  file=sys.stderr)
            return 2
        paths = [p for p in discover(paths) if p.resolve() in changed]

    t0 = time.perf_counter()
    findings, errors = analyze_paths(paths, root, rules, mesh_dims)
    if logs:
        findings += analyze_ptxas(logs, rules, cuda.demangler())
    elapsed = time.perf_counter() - t0

    baseline_path = Path(args.baseline) if args.baseline else (
        root / baseline_mod.DEFAULT_BASELINE)
    base = Counter()
    if baseline_path.exists():
        try:
            base = baseline_mod.load(baseline_path)
        except (ValueError, json.JSONDecodeError) as e:
            print(f"bad baseline {baseline_path}: {e}", file=sys.stderr)
            return 2
    # cuda-spill reads only the ptxas logs given: without them its entries
    # are neither stale nor dropped
    unread = Counter() if logs else Counter(
        {k: n for k, n in base.items() if baseline_mod.SPILL_KEY in k})
    if args.write_baseline:
        keys = Counter(k for _, k in findings) + unread
        baseline_mod.save(baseline_path, keys)
        print(f"wrote {sum(keys.values())} grandfathered finding(s) -> "
              f"{baseline_path}")
        return 0

    new, suppressed, stale = baseline_mod.apply(findings, base - unread)

    n_files = len(discover(paths)) + len(logs)
    payload = {
        "findings": [vars(f) for f in new],
        "summary": dict(Counter(f.rule for f in new)),
        "baseline": {"suppressed": suppressed, "stale": stale},
        "parse_errors": errors,
        "files_analyzed": n_files,
        "elapsed_s": round(elapsed, 4),
    }
    if args.out:
        Path(args.out).write_text(json.dumps(payload, indent=1) + "\n")
    if args.format == "json":
        print(json.dumps(payload, indent=1))
    else:
        for f in new:
            print(f.render())
        for e in errors:
            print(f"PARSE ERROR {e}", file=sys.stderr)
        if stale:
            print(f"note: {len(stale)} stale baseline entr"
                  f"{'y' if len(stale) == 1 else 'ies'} (finding fixed — "
                  "regenerate with --write-baseline to shrink the file)",
                  file=sys.stderr)
        print(f"repro-lint (torch): {len(new)} new finding(s), {suppressed} "
              f"baselined, {n_files} files in {elapsed:.2f}s", file=sys.stderr)
    if errors:
        return 2
    return 1 if new else 0


if __name__ == "__main__":
    raise SystemExit(main())
