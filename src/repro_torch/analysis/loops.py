"""Pass 6 -- a host sync in every iteration of a loop (``host-sync-in-loop``).

The counterpart of `repro/analysis/retrace.py`. The JAX pass guards the jit
cache: a Python branch or an `int()` on a tracer makes a sweep retrace or
sync. The port runs eagerly, so its hazard is the sync itself: a copy to
the host inside a loop waits for every kernel queued before it, once an
iteration, and the card idles while the host catches up. That is what
makes a path host-bound (`ROADMAP.md`, "The SSM scans are host-bound").

In `core/`, `models/` and `kernels/` (a directory of that name anywhere in
the file's path), flag ``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()`` and ``torch.cuda.synchronize()`` inside the body of a
``for`` or ``while`` loop (the ``while`` test included, a ``for``'s
iterable not: it runs once), or in the element or condition of a
comprehension. A nested ``def``/``lambda``/``class`` body is not the
loop's. A sync a loop needs (a host-side plan, a value the next
iteration's shapes depend on) carries ``# repro-lint:
disable=host-sync-in-loop`` with that reason.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.common import (Finding, SourceFile, call_name,
                                         path_parts, scope_of)

RULES = ("host-sync-in-loop",)

SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
DIRECTORIES = frozenset({"core", "models", "kernels"})
_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


def _sync(node: ast.AST) -> str | None:
    if not isinstance(node, ast.Call):
        return None
    if call_name(node) == "torch.cuda.synchronize":
        return "torch.cuda.synchronize()"
    if (isinstance(node.func, ast.Attribute) and node.func.attr in SYNC_METHODS
            and not node.args and not node.keywords):
        return f".{node.func.attr}()"
    return None


def _loop_parts(node: ast.AST) -> list[ast.AST]:
    """The parts of a loop that run once an iteration."""
    if isinstance(node, (ast.For, ast.AsyncFor)):
        return [*node.body]
    if isinstance(node, ast.While):
        return [node.test, *node.body]
    if isinstance(node, _COMPREHENSIONS):
        elts = [node.key, node.value] if isinstance(node, ast.DictComp) else [node.elt]
        return elts + [c for gen in node.generators for c in gen.ifs] + [
            gen.iter for gen in node.generators[1:]]
    return []


def run(sf: SourceFile) -> list[Finding]:
    if not DIRECTORIES & set(path_parts(sf.rel)):
        return []
    findings: list[Finding] = []

    def visit(node: ast.AST, in_loop: bool) -> None:
        what = _sync(node) if in_loop else None
        if what is not None:
            findings.append(Finding(
                path=sf.rel, line=node.lineno, col=node.col_offset,
                rule="host-sync-in-loop", scope=scope_of(sf, node),
                message=(f"'{what}' inside a loop waits for the card once an "
                         "iteration -- keep the values on the card, or sync once "
                         "after the loop"),
            ))
        parts = {id(p) for p in _loop_parts(node)}
        children = list(ast.iter_child_nodes(node))
        if isinstance(node, _COMPREHENSIONS):
            # a comprehension's ifs and later iterables sit one level down
            children = [c for c in children if not isinstance(c, ast.comprehension)] + [
                c for gen in node.generators for c in (gen.iter, *gen.ifs)]
        for child in children:
            if isinstance(child, _SCOPES):
                visit(child, False)
            else:
                visit(child, in_loop or id(child) in parts)

    visit(sf.tree, False)
    return findings
