"""Pass 3 -- random draws from torch's global generator (``rng-global``).

The counterpart of `repro/analysis/prng.py`. JAX threads explicit keys, and
its pass flags a key used twice. The port's rule is the torch form of the
same ledger: every draw comes from an explicit `torch.Generator` that the
caller seeded (`core/gibbs.py`'s sampler, `core/hyper.py`'s Wishart noise,
`serve/foldin.py`'s fold-in noise), so a chain repeats bit for bit and two
chains never share a stream. A draw from the global generator is correlated
with every other such draw in the process, and its seed is whatever ran
before. Flagged:

* ``torch.randn``, ``rand``, ``randint``, ``randperm``, ``normal``,
  ``bernoulli``, ``multinomial``, ``poisson`` and ``randn_like``,
  ``rand_like``, ``randint_like`` without ``generator=``;
* the in-place samplers ``.normal_``, ``.uniform_``, ``.exponential_``,
  ``.bernoulli_``, ``.random_``, ``.cauchy_``, ``.log_normal_`` and
  ``.geometric_`` (whatever the receiver, `torch.nn.init`'s too) without
  ``generator=``;
* ``torch.manual_seed``, ``torch.random.manual_seed``,
  ``torch.cuda.manual_seed`` and ``torch.cuda.manual_seed_all``: seeding
  the global generator, which the port never draws from.

``torch.Generator(...).manual_seed(s)`` is clean. A call that forwards
``**kw`` counts as passing ``generator=`` only when ``kw`` is bound in the
same function to a dict literal or a ``dict(...)`` call that holds
``generator`` (`core/gibbs.py`'s and `core/als.py`'s ``init``).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.common import Finding, SourceFile, call_name, scope_of

RULES = ("rng-global",)

SAMPLERS = frozenset({
    "randn", "rand", "randint", "randperm", "normal", "bernoulli", "multinomial",
    "poisson", "randn_like", "rand_like", "randint_like",
})
INPLACE_SAMPLERS = frozenset({
    "normal_", "uniform_", "exponential_", "bernoulli_", "random_", "cauchy_",
    "log_normal_", "geometric_",
})
GLOBAL_SEEDS = frozenset({
    "torch.manual_seed", "torch.random.manual_seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all",
})


def _enclosing_function(sf: SourceFile, node: ast.AST) -> ast.AST:
    cur = sf.parent(node)
    while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        cur = sf.parent(cur)
    return cur if cur is not None else sf.tree


def _holds_generator(value: ast.AST) -> bool:
    if isinstance(value, ast.Dict):
        return any(isinstance(k, ast.Constant) and k.value == "generator"
                   for k in value.keys)
    if isinstance(value, ast.Call) and call_name(value) == "dict":
        return any(kw.arg == "generator" for kw in value.keywords)
    return False


def _forwards_generator(sf: SourceFile, node: ast.Call) -> bool:
    """Whether `node` passes generator=, itself or through a local **kw
    dict that holds it."""
    for kw in node.keywords:
        if kw.arg == "generator":
            return True
        if kw.arg is None and isinstance(kw.value, ast.Name):
            scope = _enclosing_function(sf, node)
            for sub in ast.walk(scope):
                if (isinstance(sub, ast.Assign)
                        and any(isinstance(t, ast.Name) and t.id == kw.value.id
                                for t in sub.targets)
                        and _holds_generator(sub.value)):
                    return True
    return False


def _draw(node: ast.Call) -> str | None:
    """The draw's name when `node` samples or seeds globally unless it
    names a generator, else None."""
    name = call_name(node)
    if name in GLOBAL_SEEDS:
        return name
    if name is not None and name.startswith("torch.") and name.count(".") == 1 \
            and name.split(".")[1] in SAMPLERS:
        return name
    if isinstance(node.func, ast.Attribute) and node.func.attr in INPLACE_SAMPLERS:
        return f".{node.func.attr}"
    return None


def run(sf: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _draw(node)
        if name is None:
            continue
        if name in GLOBAL_SEEDS:
            message = (f"'{name}()' seeds torch's global generator -- the port "
                       "draws only from explicit torch.Generator objects; seed "
                       "one of those (torch.Generator(device).manual_seed(s))")
        elif _forwards_generator(sf, node):
            continue
        else:
            message = (f"'{name}()' without generator= draws from torch's global "
                       "generator -- pass the caller's seeded torch.Generator")
        findings.append(Finding(
            path=sf.rel, line=node.lineno, col=node.col_offset, rule="rng-global",
            scope=scope_of(sf, node), message=message,
        ))
    return findings
