"""Shared infrastructure of the port's lint (`python -m repro_torch.analysis`).

Stdlib only: no torch, numpy, jax or `repro`, and the analyzer never
imports the code it checks, so it runs in a bare job and on the card's
machine, which has no JAX. The Python side is this package's own copy of
the framework-free parts of `repro/analysis/common.py`:

* **Finding** -- one `file:line rule-id message` diagnostic with a stable
  `baseline_key()` that survives unrelated line-number churn (the key holds
  the *source text* of the flagged line plus its scope, not its position).

* **SourceFile** -- a parsed Python file: AST, raw lines, per-line
  suppression directives (``# repro-lint: disable=<rule>[,<rule>...]``),
  and a parent map.

* **ClassInfo / lock modelling** -- per-class discovery of lock attributes
  and Condition aliases, plus `iter_with_held()`, the traversal that yields
  every node of a function body with the set of locks lexically held
  there; a method whose name ends in ``_locked`` is analyzed as if
  ``self._lock`` were held on entry.

Added for the port's CUDA sources:

* **CudaSource** -- a ``.cu``/``.cuh`` file with its comments blanked (and a
  second copy with its string literals blanked too), positions and line
  breaks kept, and the same directive written as a ``//`` comment:
  ``// repro-lint: disable=<rule>``.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

# attribute-call names treated as WRITES to their receiver for guarded-field
# inference: `self.xs.append(v)` mutates `self.xs` exactly like a store would
MUTATOR_METHODS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "discard", "remove", "pop", "popitem", "popleft", "clear", "update",
    "setdefault", "move_to_end", "sort", "reverse", "rotate",
})

# the method convention: these run before the object is shared across
# threads, so unlocked stores in them define fields rather than race
CONSTRUCTOR_METHODS = frozenset({"__init__", "__new__", "__post_init__"})

LOCKED_SUFFIX = "_locked"
# the lock the `*_locked` suffix convention refers to
CONVENTION_LOCK = "_lock"

_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=([A-Za-z0-9_,\-]+)")


@dataclass(frozen=True)
class Finding:
    """One diagnostic. `scope` is the dotted lexical scope (Class.method)
    the finding sits in — part of the baseline key so a finding does not
    escape the baseline just because unrelated lines shifted it."""

    path: str          # posix-relative to the analysis root
    line: int
    col: int
    rule: str
    message: str
    scope: str = ""

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col} {self.rule} {self.message}"

    def baseline_key(self, source_line: str = "") -> str:
        norm = " ".join(source_line.split())
        return f"{self.path}::{self.rule}::{self.scope}::{norm}"

    def sort_key(self) -> tuple:
        return (self.path, self.line, self.col, self.rule)


def dotted_name(node: ast.AST) -> str | None:
    """`a.b.c` / `a` as a dotted string, None for anything non-name-like."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> str | None:
    return dotted_name(node.func)


def self_attr(node: ast.AST) -> str | None:
    """'x' when node is exactly `self.x`, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class SourceFile:
    """One parsed source file plus the side tables every pass needs."""

    def __init__(self, path: Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=str(path))
        self.suppressions = self._collect_suppressions()
        self.span_suppressions = self._anchor_suppressions()
        self.parents: dict[int, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[id(child)] = parent

    @classmethod
    def load(cls, path: Path, root: Path) -> "SourceFile":
        return cls(path, relative(path, root), path.read_text())

    def _collect_suppressions(self) -> dict[int, frozenset[str]]:
        out: dict[int, frozenset[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            if "repro-lint" not in line:
                continue
            m = _SUPPRESS_RE.search(line)
            if m:
                rules = frozenset(
                    r.strip() for r in m.group(1).split(",") if r.strip()
                )
                out[i] = rules
        return out

    def _anchor_suppressions(self) -> list[tuple[int, int, frozenset[str]]]:
        """Extend each suppression comment to its enclosing statement span.

        A ``# repro-lint: disable=<rule>`` on a decorator line or on the
        first line of a multiline call must cover the whole statement the
        comment sits on, not just its physical line (findings anchor to
        whichever line the relevant AST node starts on).  Simple statements
        are covered end to end; compound statements (def/class/if/with/...)
        are covered over their *header* only — decorators through the line
        before the first body statement — so a disable on a ``def`` line
        can never silence the entire function body.
        """
        if not self.suppressions:
            return []
        spans: list[tuple[int, int]] = []
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.stmt):
                continue
            start = node.lineno
            deco = getattr(node, "decorator_list", None)
            if deco:
                start = min([start] + [d.lineno for d in deco])
            body = getattr(node, "body", None)
            if isinstance(body, list) and body and isinstance(body[0],
                                                              ast.stmt):
                end = body[0].lineno - 1  # header only, never the body
            else:
                end = node.end_lineno or node.lineno
            spans.append((start, max(start, end)))
        out: list[tuple[int, int, frozenset[str]]] = []
        for line, rules in self.suppressions.items():
            best: tuple[int, int] | None = None
            for start, end in spans:
                if start <= line <= end and (
                        best is None
                        or end - start < best[1] - best[0]):
                    best = (start, end)
            if best is not None:
                out.append((best[0], best[1], rules))
        return out

    def suppressed(self, line: int, rule: str) -> bool:
        rules = self.suppressions.get(line)
        if rules is not None and (rule in rules or "all" in rules):
            return True
        for start, end, span_rules in self.span_suppressions:
            if start <= line <= end and (rule in span_rules
                                         or "all" in span_rules):
                return True
        return False

    def source_line(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""

    def parent(self, node: ast.AST) -> ast.AST | None:
        return self.parents.get(id(node))


# ---------------------------------------------------------------------------
# class / lock modelling
# ---------------------------------------------------------------------------
@dataclass
class ClassInfo:
    node: ast.ClassDef
    name: str
    methods: dict[str, ast.FunctionDef | ast.AsyncFunctionDef] = field(
        default_factory=dict)
    lock_attrs: set[str] = field(default_factory=set)     # real locks
    rlock_attrs: set[str] = field(default_factory=set)    # reentrant subset
    cond_aliases: dict[str, str] = field(default_factory=dict)  # cond -> lock

    def canonical_lock(self, attr: str) -> str:
        """Resolve a Condition alias to the lock it acquires."""
        return self.cond_aliases.get(attr, attr)

    def is_lock_like(self, attr: str) -> bool:
        return (attr in self.lock_attrs or attr in self.cond_aliases
                or "lock" in attr.lower())


def _lock_ctor(node: ast.AST) -> str | None:
    """'lock' / 'rlock' / 'cond' when node constructs a threading primitive."""
    if not isinstance(node, ast.Call):
        return None
    name = call_name(node)
    if name is None:
        return None
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "Lock":
        return "lock"
    if leaf == "RLock":
        return "rlock"
    if leaf == "Condition":
        return "cond"
    return None


def collect_classes(sf: SourceFile) -> list[ClassInfo]:
    """Lexical class table: methods, lock attributes, Condition aliases.

    Inheritance is intentionally not resolved — guarded-field inference is
    per-lexical-class (a subclass in another module does not see the parent's
    guarded set; document, don't guess)."""
    out: list[ClassInfo] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        info = ClassInfo(node=node, name=node.name)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info.methods[item.name] = item
        for meth in info.methods.values():
            for sub in ast.walk(meth):
                if not isinstance(sub, ast.Assign):
                    continue
                kind = _lock_ctor(sub.value)
                if kind is None:
                    continue
                for tgt in sub.targets:
                    attr = self_attr(tgt)
                    if attr is None:
                        continue
                    if kind == "lock":
                        info.lock_attrs.add(attr)
                    elif kind == "rlock":
                        info.lock_attrs.add(attr)
                        info.rlock_attrs.add(attr)
                    else:  # Condition(maybe_lock)
                        args = sub.value.args
                        under = self_attr(args[0]) if args else None
                        if under is not None:
                            info.cond_aliases[attr] = under
                        else:
                            # a bare Condition owns its own (hidden) lock
                            info.lock_attrs.add(attr)
        out.append(info)
    return out


def with_locks(node: ast.With | ast.AsyncWith, info: ClassInfo | None
               ) -> set[str]:
    """Lock attributes a `with` statement acquires (`with self._lock:` /
    `with self._cond:` — aliases canonicalized)."""
    held: set[str] = set()
    for item in node.items:
        attr = self_attr(item.context_expr)
        if attr is None:
            continue
        if info is not None:
            if info.is_lock_like(attr):
                held.add(info.canonical_lock(attr))
        elif "lock" in attr.lower():
            held.add(attr)
    return held


def base_held(func: ast.FunctionDef | ast.AsyncFunctionDef) -> frozenset[str]:
    """Locks a function may assume held on entry: the `*_locked` suffix
    convention promises the caller acquired `self._lock`."""
    if func.name.endswith(LOCKED_SUFFIX):
        return frozenset({CONVENTION_LOCK})
    return frozenset()


def iter_with_held(func: ast.FunctionDef | ast.AsyncFunctionDef,
                   info: ClassInfo | None = None):
    """Yield `(node, held)` for every node in `func`'s body, where `held`
    is the frozenset of lock attrs lexically held at that node.

    Nested function/lambda bodies reset `held` to empty — they execute
    later (thread targets, callbacks), not under the enclosing `with`."""

    def visit(node: ast.AST, held: frozenset[str], top: bool):
        if not top and isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            inner = (base_held(node)
                     if not isinstance(node, ast.Lambda) else frozenset())
            yield node, held
            for child in ast.iter_child_nodes(node):
                yield from visit(child, inner, False)
            return
        yield node, held
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held | frozenset(with_locks(node, info))
            for item in node.items:
                yield from visit(item, held, False)
            for child in node.body:
                yield from visit(child, inner, False)
            return
        for child in ast.iter_child_nodes(node):
            yield from visit(child, held, False)

    start = base_held(func)
    for child in ast.iter_child_nodes(func):
        yield from visit(child, start, False)


def access_kind(sf: SourceFile, node: ast.Attribute) -> str:
    """'read' / 'write' for a `self.x` attribute node.

    Writes: plain stores (`self.x = ...`, `self.x += ...`, `del self.x`),
    container-slot stores (`self.x[k] = ...`, `del self.x[k]`), and calls
    to mutating methods (`self.x.append(...)`, `self.x[k].append(...)`)."""
    if isinstance(node.ctx, (ast.Store, ast.Del)):
        return "write"
    parent = sf.parent(node)
    # self.x[k] = v  /  del self.x[k]
    if (isinstance(parent, ast.Subscript)
            and isinstance(parent.ctx, (ast.Store, ast.Del))):
        return "write"
    # self.x.append(v)  /  self.x[k].append(v)
    hop = parent
    if isinstance(hop, ast.Subscript) and isinstance(hop.ctx, ast.Load):
        hop = sf.parent(hop)
    if (isinstance(hop, ast.Attribute) and hop.attr in MUTATOR_METHODS
            and isinstance(sf.parent(hop), ast.Call)
            and sf.parent(hop).func is hop):
        return "write"
    return "read"


def scope_of(sf: SourceFile, node: ast.AST) -> str:
    """Dotted Class.method scope containing `node` (lexical)."""
    parts: list[str] = []
    cur = sf.parent(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            parts.append(cur.name)
        cur = sf.parent(cur)
    return ".".join(reversed(parts))


# ---------------------------------------------------------------------------
# CUDA C++ sources
# ---------------------------------------------------------------------------
_CU_SUPPRESS_RE = re.compile(r"//\s*repro-lint:\s*disable=([A-Za-z0-9_,\-]+)")
CUDA_SUFFIXES = (".cu", ".cuh")


def _blank(text: str, keep_strings: bool) -> str:
    """`text` with every comment (and, unless keep_strings, every string and
    character literal's contents) replaced by spaces; newlines and so every
    position stay where they were."""
    out = list(text)
    i, n = 0, len(text)

    def wipe(a: int, b: int) -> None:
        for j in range(a, b):
            if out[j] != "\n":
                out[j] = " "

    while i < n:
        c = text[i]
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            wipe(i, j)
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            wipe(i, j)
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and text[j] != c and text[j] != "\n":
                j += 2 if text[j] == "\\" else 1
            if not keep_strings:
                wipe(i + 1, min(j, n))
            i = j + 1
        else:
            i += 1
    return "".join(out)


class CudaSource:
    """One CUDA C++ file: its text, its text without comments (`code`:
    strings blanked as well; `code_strings`: strings kept, for inline PTX),
    and its ``// repro-lint: disable=<rule>`` directives, which cover their
    own line."""

    def __init__(self, path: Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.code = _blank(text, keep_strings=False)
        self.code_strings = _blank(text, keep_strings=True)
        self.suppressions: dict[int, frozenset[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _CU_SUPPRESS_RE.search(line)
            if m:
                self.suppressions[i] = frozenset(
                    r.strip() for r in m.group(1).split(",") if r.strip())

    def line_of(self, pos: int) -> int:
        return self.text.count("\n", 0, pos) + 1

    def col_of(self, pos: int) -> int:
        return pos - (self.text.rfind("\n", 0, pos) + 1)

    def suppressed(self, line: int, rule: str) -> bool:
        rules = self.suppressions.get(line, frozenset())
        return rule in rules or "all" in rules

    def source_line(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""


def relative(path: Path, root: Path) -> str:
    """`path` posix-relative to `root`, or as given when outside it."""
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def path_parts(rel: str) -> tuple[str, ...]:
    """The directory names of a posix path, without the file's own name."""
    return tuple(rel.split("/")[:-1])
