"""Pass 1 -- lock discipline for the hand-rolled concurrency in `serve/`.

The port's copy of `repro/analysis/locks.py`: the rules are
framework-free and unchanged.

Three rules, all per-lexical-class:

``guarded-field``
    Infer each lock's *guarded set*: every `self.<field>` that is written
    (stored, aug-assigned, container-slot-assigned, or mutated via
    `.append`-style calls) while that lock is held — inside a
    ``with self.<lock>:`` block or inside a ``*_locked`` method (the suffix
    convention promises `self._lock`).  Then flag any read or write of a
    guarded field outside a context holding its lock.  Constructor methods
    (`__init__` et al.) are exempt: they run before the object is shared.

``locked-call``
    A call to a ``*_locked`` method from a caller that neither holds
    ``self._lock`` lexically nor is itself ``*_locked``.  The callee skips
    acquisition by contract; calling it unlocked is a data race.

``lock-reacquire``
    A ``*_locked`` method that re-enters ``with self._lock:`` — with the
    plain (non-reentrant) `threading.Lock` the tier uses, that is a
    self-deadlock the moment the convention is honored by the caller.
    RLock-backed locks are exempt.

Known limits (by design): inference is lexical and per-class -- inherited
guarded sets and attributes of *other* objects (`host.staged = ...`) are
out of scope; `serve/faults.py::assert_holds` is the runtime cross-check
that covers the dynamic side.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.common import (
    CONSTRUCTOR_METHODS,
    CONVENTION_LOCK,
    LOCKED_SUFFIX,
    ClassInfo,
    Finding,
    SourceFile,
    access_kind,
    collect_classes,
    iter_with_held,
    self_attr,
    with_locks,
)

RULES = ("guarded-field", "locked-call", "lock-reacquire")


def _guarded_sets(info: ClassInfo) -> dict[str, set[str]]:
    """lock attr -> set of self.<field> names written while holding it."""
    guarded: dict[str, set[str]] = {}
    skip = info.lock_attrs | set(info.cond_aliases)
    for name, meth in info.methods.items():
        if name in CONSTRUCTOR_METHODS:
            continue
        sf = info._sf  # attached by run()
        for node, held in iter_with_held(meth, info):
            if not held or not isinstance(node, ast.Attribute):
                continue
            attr = self_attr(node)
            if attr is None or attr in skip:
                continue
            if access_kind(sf, node) == "write":
                for lock in held:
                    guarded.setdefault(lock, set()).add(attr)
    return guarded


def run(sf: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    for info in collect_classes(sf):
        if not info.lock_attrs and not info.cond_aliases:
            continue
        info._sf = sf  # let helpers reach the parent map
        guarded = _guarded_sets(info)
        field_to_locks: dict[str, set[str]] = {}
        for lock, fields in guarded.items():
            for f in fields:
                field_to_locks.setdefault(f, set()).add(lock)
        skip = info.lock_attrs | set(info.cond_aliases)

        for name, meth in info.methods.items():
            is_ctor = name in CONSTRUCTOR_METHODS
            is_locked_meth = name.endswith(LOCKED_SUFFIX)
            scope = f"{info.name}.{name}"
            for node, held in iter_with_held(meth, info):
                # -- guarded-field ----------------------------------------
                if (not is_ctor and isinstance(node, ast.Attribute)):
                    attr = self_attr(node)
                    if (attr is not None and attr not in skip
                            and attr in field_to_locks
                            and not (field_to_locks[attr] & held)):
                        locks = "/".join(
                            f"self.{l}" for l in sorted(field_to_locks[attr]))
                        kind = access_kind(sf, node)
                        findings.append(Finding(
                            path=sf.rel, line=node.lineno,
                            col=node.col_offset, rule="guarded-field",
                            scope=scope,
                            message=(
                                f"{kind} of 'self.{attr}' outside {locks} "
                                "(field is written under that lock elsewhere "
                                f"in {info.name})"
                            ),
                        ))
                # -- locked-call ------------------------------------------
                if isinstance(node, ast.Call):
                    callee = self_attr(node.func)
                    if (callee is not None and callee.endswith(LOCKED_SUFFIX)
                            and callee in info.methods
                            and CONVENTION_LOCK not in held):
                        findings.append(Finding(
                            path=sf.rel, line=node.lineno,
                            col=node.col_offset, rule="locked-call",
                            scope=scope,
                            message=(
                                f"call to 'self.{callee}()' without holding "
                                f"'self.{CONVENTION_LOCK}' (callers of "
                                f"*{LOCKED_SUFFIX} methods must hold the "
                                "lock or be *_locked themselves)"
                            ),
                        ))
                # -- lock-reacquire ---------------------------------------
                if (is_locked_meth
                        and isinstance(node, (ast.With, ast.AsyncWith))):
                    for lock in with_locks(node, info):
                        if (lock == CONVENTION_LOCK
                                and lock not in info.rlock_attrs):
                            findings.append(Finding(
                                path=sf.rel, line=node.lineno,
                                col=node.col_offset, rule="lock-reacquire",
                                scope=scope,
                                message=(
                                    f"'{name}' re-acquires 'self.{lock}' it "
                                    "already holds by the *_locked "
                                    "convention — self-deadlock on a "
                                    "non-reentrant Lock"
                                ),
                            ))
    return findings
