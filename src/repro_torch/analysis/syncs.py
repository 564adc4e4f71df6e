"""Pass 2 -- device work under a lock (``sync-under-lock``), torch names.

The counterpart of `repro/analysis/syncs.py`, which knows only jax and
numpy names. The serving tier's locks guard metadata: epoch counters,
binding pointers, health tables, the launch counts. Every request thread
and every host loop takes them, and all of them launch on the card's one
default stream. A torch call, a copy to the host or a sync made while one
is held turns the lock into a device-latency convoy: one slow kernel
stalls every thread waiting on it. The discipline (stage off the lock,
flip pointers under it; `serve/cluster.py`) is lexical:

Flag any call lexically inside ``with self.<lock>:`` (a lock attribute
the class constructs, a Condition over one, or any attribute whose name
holds "lock"; a ``*_locked`` method holds ``self._lock``) whose callee is

* ``torch.*`` (any function of the torch namespace), or
* a method ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``,
  ``.to(...)``, ``.synchronize()`` or ``.scoring_matrices()`` (the
  ensemble's build of its device tables), whatever the receiver.

Nested ``def``/``lambda`` bodies run later and are exempt. Intentional
stop-the-world sections carry ``# repro-lint: disable=sync-under-lock``
with their reason.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.common import (
    Finding,
    SourceFile,
    call_name,
    collect_classes,
    iter_with_held,
)

RULES = ("sync-under-lock",)

#: method names that copy, sync or build device data wherever the receiver lives
DEVICE_METHODS = frozenset({"item", "cpu", "numpy", "tolist", "to", "synchronize",
                            "scoring_matrices"})


def device_call(node: ast.Call) -> str | None:
    """A short reason when the call does device work, else None."""
    name = call_name(node)
    if name is not None and name.startswith("torch."):
        return f"'{name}' runs torch work"
    if isinstance(node.func, ast.Attribute) and node.func.attr in DEVICE_METHODS:
        return f"'.{node.func.attr}()' copies, syncs or builds device data"
    return None


def run(sf: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    for info in collect_classes(sf):
        for name, meth in info.methods.items():
            scope = f"{info.name}.{name}"
            for node, held in iter_with_held(meth, info):
                if not held or not isinstance(node, ast.Call):
                    continue
                reason = device_call(node)
                if reason is None:
                    continue
                locks = ", ".join(f"self.{lk}" for lk in sorted(held))
                findings.append(Finding(
                    path=sf.rel, line=node.lineno, col=node.col_offset,
                    rule="sync-under-lock", scope=scope,
                    message=(
                        f"{reason} while holding {locks} -- device work "
                        "under a lock stalls every thread waiting on it "
                        "(stage off the lock, flip under it)"
                    ),
                ))
    return findings
