"""Baseline file handling: grandfather existing findings, gate new ones.

The port's copy of `repro/analysis/baseline.py`. The baseline (checked in
as ``.repro-torch-lint-baseline.json``) maps a stable finding key to an
occurrence count. The key is ``path::rule::scope::normalized-source-line``
-- no line numbers, so unrelated edits that shift a grandfathered finding
do not resurrect it, while *changing the flagged line itself* (or moving it
to a new scope) does. A `cuda-spill` key is ``kernel-file::cuda-spill::
demangled-entry::``: the entry, not its byte counts. A count accommodates
N identical lines in one scope.

Workflow: fix every finding you can; suppress intentional ones in-line
(``# repro-lint: disable=<rule>`` with a justification, ``//`` in CUDA
sources); only what remains goes in the baseline via ``python -m
repro_torch.analysis --write-baseline``, each entry with its reason under
``reasons`` (kept when the file is rewritten). New findings against the
checked-in baseline fail the gate. Stale entries (the finding
disappeared) are reported as a warning so the file shrinks over time;
`cuda-spill` entries only where ptxas logs were read, and a rewrite
without logs keeps them.
"""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

from repro_torch.analysis.common import Finding

BASELINE_VERSION = 1
DEFAULT_BASELINE = ".repro-torch-lint-baseline.json"
#: the part of a cuda-spill key that marks it
SPILL_KEY = "::cuda-spill::"


def load(path: Path) -> Counter:
    data = json.loads(path.read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"unsupported baseline version {data.get('version')!r} in {path}"
        )
    return Counter({str(k): int(v) for k, v in data["findings"].items()})


def reasons(path: Path) -> dict[str, str]:
    """The reason recorded for each baselined key ({} without a file)."""
    if not path.exists():
        return {}
    return dict(json.loads(path.read_text()).get("reasons", {}))


def save(path: Path, keys: Counter) -> None:
    kept = {k: v for k, v in reasons(path).items() if k in keys}
    payload = {
        "version": BASELINE_VERSION,
        "comment": (
            "grandfathered findings of the port's lint; each needs its reason "
            "under 'reasons' -- regenerate with: python -m repro_torch.analysis "
            "--write-baseline"
        ),
        "findings": {k: keys[k] for k in sorted(keys)},
        "reasons": {k: kept[k] for k in sorted(kept)},
    }
    path.write_text(json.dumps(payload, indent=1, sort_keys=False) + "\n")


def apply(findings: list[tuple[Finding, str]], baseline: Counter
          ) -> tuple[list[Finding], int, list[str]]:
    """Split findings into (new, n_suppressed, stale_keys).

    `findings` pairs each Finding with its baseline key. Up to the
    baselined count of each key is suppressed; the rest are new. Keys in
    the baseline with no remaining occurrence are stale.
    """
    budget = Counter(baseline)
    new: list[Finding] = []
    suppressed = 0
    for f, key in findings:
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            suppressed += 1
        else:
            new.append(f)
    stale = sorted(k for k, n in budget.items() if n > 0)
    return new, suppressed, stale
