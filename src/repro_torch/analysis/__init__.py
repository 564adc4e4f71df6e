"""The port's lint: static checks of the rules `repro_torch` keeps.

The counterpart of `repro/analysis/` (repro-lint), whose passes know jax,
`pl.pallas_call` and PRNG keys and so see nothing of torch or CUDA C++.
Eight passes, stdlib only (`ast` for Python, `re` for CUDA C++ and ptxas
output); the analyzer never imports the code it checks, nor torch, numpy,
jax or `repro`, so it runs in a bare job and on the card's machine:

* ``locks``  -- lock discipline (`guarded-field`, `locked-call`,
  `lock-reacquire`), the JAX package's pass as it is.
* ``syncs``  -- `sync-under-lock`: torch calls and device copies or syncs
  under a lock.
* ``rng``    -- `rng-global`: draws from torch's global generator (JAX:
  `prng`).
* ``sums``   -- `ordered-sum`: atomic accumulating scatters, whose order the
  card does not fix.
* ``collectives`` -- `ppermute-perm`, `collective-branch`,
  `collective-axis`: the ranks' point-to-point pairs, collectives on one
  arm of a rank test, mesh dims no mesh declares (JAX: `collectives`).
* ``tf32``   -- `tf32`: TF32 in fp32 products (JAX: `sharding`).
* ``loops``  -- `host-sync-in-loop`: a host sync once an iteration in
  `core/`, `models/`, `kernels/` (JAX: `retrace`).
* ``cuda``   -- `cuda-float-atomic`, `cuda-launch-guard`,
  `cuda-launch-check`, `cuda-fallback`, `cuda-spill` (JAX: `pallas`).

CLI: ``python -m repro_torch.analysis [paths...]`` (see
`repro_torch.analysis.cli`; ``--list-rules`` prints the catalogue). Its
baseline is ``.repro-torch-lint-baseline.json``; a suppression is
``# repro-lint: disable=<rule>`` with its reason (``//`` in CUDA sources).
"""
from repro_torch.analysis.cli import ALL_RULES, RULE_DOCS, analyze_paths, main
from repro_torch.analysis.common import Finding, SourceFile

__all__ = ["ALL_RULES", "RULE_DOCS", "Finding", "SourceFile",
           "analyze_paths", "analyze_source", "main"]


def analyze_source(code: str, rules=None, filename: str = "<snippet>"):
    """Analyze a source string (a CUDA one where `filename` ends in .cu or
    .cuh) -- the fixture seam of tests/test_torch_analysis.py. Returns
    unsuppressed findings sorted by position."""
    from pathlib import Path

    from repro_torch.analysis.cli import analyze_file, load_source

    ruleset = frozenset(rules) if rules is not None else frozenset(ALL_RULES)
    return [f for f, _ in analyze_file(load_source(Path(filename), filename, code),
                                       ruleset)]
