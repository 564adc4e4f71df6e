"""Pass 5 -- TF32 in fp32 products (``tf32``).

The counterpart of `repro/analysis/sharding.py`. The JAX pass guards the
layouts a jitted sweep is compiled for; the port has no layouts to drift,
and its silent precision switch is TF32. The port's rule is that fp32
means IEEE fp32: `device.py` turns TF32 off for every entry point on the
card and `chip_smoke.py` states the same, and the plain versions, the
float64 checks and the parity with the JAX package all assume it. A
TF32 product keeps 10 bits of mantissa. Flagged:

* an assignment to any ``*.allow_tf32`` (``torch.backends.cuda.matmul``,
  ``torch.backends.cudnn``) of anything but the constant ``False``;
* ``torch.set_float32_matmul_precision(p)`` with ``p`` anything but the
  constant ``"highest"``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.common import (Finding, SourceFile, call_name,
                                         dotted_name, scope_of)

RULES = ("tf32",)


def _flag(sf: SourceFile, node: ast.AST, what: str) -> Finding:
    return Finding(
        path=sf.rel, line=node.lineno, col=node.col_offset, rule="tf32",
        scope=scope_of(sf, node),
        message=(f"{what} -- TF32 rounds fp32 products to 10 mantissa bits; "
                 "the port's fp32 is IEEE fp32 (device.py)"),
    )


def run(sf: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            off = isinstance(node.value, ast.Constant) and node.value.value is False
            for t in targets:
                name = dotted_name(t)
                if name is not None and name.endswith(".allow_tf32") and not off:
                    findings.append(_flag(sf, node, f"'{name}' is set to something "
                                                    "other than False"))
        elif (isinstance(node, ast.Call)
              and (call_name(node) or "").endswith("set_float32_matmul_precision")):
            arg = node.args[0] if node.args else next(
                (k.value for k in node.keywords if k.arg == "precision"), None)
            if not (isinstance(arg, ast.Constant) and arg.value == "highest"):
                findings.append(_flag(sf, node, "float32 matmul precision other "
                                                "than 'highest'"))
    return findings
