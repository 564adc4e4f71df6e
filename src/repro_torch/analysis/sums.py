"""Pass 4 -- sums whose order the card does not fix (``ordered-sum``).

The JAX pass of the same slot, `repro/analysis/collectives.py`, guards the
SPMD exchanges of the distributed sampler; its three rules have their
counterparts in `analysis/collectives.py`, for the sampler's ranks
(`core/exchange.py::RankExchange`). What the port also promises is the
same bits from every run, every mode and every layout: the ring and the
allgather sampler agree bit for bit, and so do the ranks and the
one-process sampler (`core/distributed.py`), which holds only where no sum
depends on the order threads reach memory (the ranks' psum is an
all-gather and a sum in rank order, not an all_reduce). On the card an
accumulating scatter is atomic, so its order, and its fp32 rounding,
changes from run to run. Flagged, whatever the receiver, except numpy's
(`np.`/`numpy.`, host code):

* ``index_add``/``index_add_``, ``scatter_add``/``scatter_add_``;
* ``scatter_reduce``/``scatter_reduce_`` and ``index_reduce``/
  ``index_reduce_``, unless their ``reduce`` is the constant ``"amax"`` or
  ``"amin"`` (exact in any order);
* ``index_put``/``index_put_`` and ``put``/``put_`` with ``accumulate=True``
  (keyword or third argument);
* ``bincount`` with ``weights`` (keyword or second argument).

The fixed-order replacement is `core/gibbs.py::segment_reduce_rows` (a
segment's rows added in row order) and `sum_rows_by_id` for unsorted ids.
A CPU-only reference that a test holds the port to carries
``# repro-lint: disable=ordered-sum`` with that reason.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.common import Finding, SourceFile, call_name, scope_of

RULES = ("ordered-sum",)

SCATTERS = frozenset({"index_add", "index_add_", "scatter_add", "scatter_add_"})
REDUCES = frozenset({"scatter_reduce", "scatter_reduce_", "index_reduce", "index_reduce_"})
ORDER_FREE = frozenset({"amax", "amin"})
ACCUMULATING_PUTS = frozenset({"index_put", "index_put_", "put", "put_"})
_HOST = ("np.", "numpy.")


def _true(node: ast.AST | None) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _arg(node: ast.Call, pos: int, kw: str) -> ast.AST | None:
    """A call's argument by keyword, else by position (counted after the
    receiver for a method, after the tensor for torch.<fn>(x, ...))."""
    for k in node.keywords:
        if k.arg == kw:
            return k.value
    name = call_name(node) or ""
    if name.startswith("torch.") and name.count(".") == 1:
        pos += 1
    return node.args[pos] if len(node.args) > pos else None


def _unordered(node: ast.Call) -> str | None:
    if not isinstance(node.func, ast.Attribute):
        return None
    name = call_name(node) or ""
    if name.startswith(_HOST):
        return None
    leaf = node.func.attr
    if leaf in SCATTERS:
        return leaf
    if leaf in REDUCES:
        how = _arg(node, 3, "reduce")
        if not (isinstance(how, ast.Constant) and how.value in ORDER_FREE):
            return leaf
    if leaf in ACCUMULATING_PUTS and _true(_arg(node, 2, "accumulate")):
        return f"{leaf}(accumulate=True)"
    if leaf == "bincount" and _arg(node, 0, "weights") is not None:
        return "bincount(weights=...)"
    return None


def run(sf: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        what = _unordered(node)
        if what is None:
            continue
        findings.append(Finding(
            path=sf.rel, line=node.lineno, col=node.col_offset, rule="ordered-sum",
            scope=scope_of(sf, node),
            message=(f"'{what}' accumulates atomically on the card: its order and "
                     "fp32 rounding change from run to run -- add in a fixed order "
                     "(core/gibbs.py::segment_reduce_rows, sum_rows_by_id)"),
        ))
    return findings
