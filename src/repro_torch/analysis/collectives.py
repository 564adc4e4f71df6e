"""Pass 8 -- the ranks' collectives (``ppermute-perm``, ``collective-branch``,
``collective-axis``).

The counterpart of `repro/analysis/collectives.py`'s three SPMD rules, for
`torch.distributed`: the distributed sampler's ranks (`core/exchange.py`)
and the LM's mesh (`models/layers.py`, `launch/mesh.py`). A wrong peer or
a one-armed collective hangs or corrupts only at a real rank count, and
the CPU tests' gloo ranks happily compute *something*:

* **ppermute-perm** -- in a function's set of point-to-point operations
  (``dist.isend``/``send``/``irecv``/``recv`` and ``dist.P2POp`` for
  ``batch_isend_irecv``), each send to ``(rank + d) % n`` must be paired
  with a receive from ``(rank - d) % n`` over the same ``n`` (and the
  reverse): an unpaired send waits for a receive no rank posts. A peer
  ``rank + d`` that is not taken ``% n`` leaves the group at the last
  rank. Peers are resolved through the function's assignments and the
  class's ``self.<name> = ...``; a peer of another form is not checked.

* **collective-branch** -- a ``dist.*`` or ``funcol.*`` collective, a
  ``dist.P2POp``, or a call that reaches one (same-file functions and
  methods, expanded two levels deep), reachable from only one arm of an
  ``if`` whose test reads the rank (a name or attribute with "rank" in
  it), is a deadlock: the ranks that take the other arm never enter it.
  Arms are compared as the ordered sequences of collectives they issue.

* **collective-axis** -- a mesh dim named in ``<mesh>[...]``,
  ``get_group(...)``, ``get_local_rank(...)`` or ``mesh_dim=`` must be
  declared by some ``init_device_mesh(..., mesh_dim_names=...)`` (or
  ``DeviceMesh(...)``) in the linted tree, resolved through the file's
  assignments and string constants. Only string literals and names that
  resolve to them are checked, and only where the tree declares a dim.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.common import Finding, SourceFile, call_name, scope_of

RULES = ("ppermute-perm", "collective-branch", "collective-axis")

DIST_BASES = ("dist", "torch.distributed", "funcol", "c10d")
COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "all_gather_tensor", "all_gather_tensor_autograd", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "broadcast",
    "broadcast_object_list", "gather", "scatter", "reduce", "barrier",
    "monitored_barrier", "send", "recv", "isend", "irecv", "batch_isend_irecv",
    "new_group", "P2POp",
})
SENDS = frozenset({"isend", "send"})
RECVS = frozenset({"irecv", "recv"})
PEER_KEYWORDS = ("dst", "src", "group_dst", "group_src", "peer", "group_peer")
MESH_CTORS = frozenset({"init_device_mesh", "DeviceMesh"})
DIM_METHODS = frozenset({"get_group", "get_local_rank"})
_EXPAND_DEPTH = 2
_RESOLVE_DEPTH = 4


def _leaf(name: str | None) -> str | None:
    return name.rsplit(".", 1)[-1] if name else None


def _dist_call(node: ast.Call) -> str | None:
    """The collective a call issues (its leaf name), else None."""
    name = call_name(node)
    if not name or "." not in name and name != "P2POp":
        return None
    base, _, leaf = name.rpartition(".")
    if leaf == "P2POp" or (base in DIST_BASES and leaf in COLLECTIVES):
        return leaf
    return None


def _functions(tree: ast.AST):
    return [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _enclosing(sf: SourceFile, node: ast.AST, kinds) -> ast.AST | None:
    cur = sf.parent(node)
    while cur is not None and not isinstance(cur, kinds):
        cur = sf.parent(cur)
    return cur


def _assignments(nodes) -> dict[str, list[ast.AST]]:
    """name or "self.attr" -> the expressions assigned to it, a tuple target
    taking the matching element of a tuple value, else the whole value."""
    out: dict[str, list[ast.AST]] = {}

    def bind(target, value):
        if isinstance(target, ast.Name):
            out.setdefault(target.id, []).append(value)
        elif (isinstance(target, ast.Attribute) and isinstance(target.value, ast.Name)
              and target.value.id == "self"):
            out.setdefault(f"self.{target.attr}", []).append(value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) and len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    bind(t, v)
            else:
                for t in target.elts:
                    bind(t, value)

    for node in nodes:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign):
                for t in sub.targets:
                    bind(t, sub.value)
            elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                bind(sub.target, sub.value)
    return out


def _key(node: ast.AST) -> str | None:
    if isinstance(node, ast.Name):
        return node.id
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return f"self.{node.attr}"
    return None


def _resolve(node: ast.AST, env: dict[str, list[ast.AST]], depth: int = _RESOLVE_DEPTH
             ) -> ast.AST:
    """`node` with each name bound once in `env` replaced by its value."""
    if depth <= 0:
        return node
    key = _key(node)
    if key is not None and len(env.get(key, ())) == 1:
        return _resolve(env[key][0], env, depth - 1)
    if isinstance(node, ast.BinOp):
        return ast.BinOp(left=_resolve(node.left, env, depth), op=node.op,
                         right=_resolve(node.right, env, depth))
    return node


def _reads_rank(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        name = sub.id if isinstance(sub, ast.Name) else (
            sub.attr if isinstance(sub, ast.Attribute) else None)
        if name and "rank" in name.lower():
            return True
    return False


# ---------------------------------------------------------------------------
# ppermute-perm
# ---------------------------------------------------------------------------
def _p2p(node: ast.Call) -> tuple[str, ast.AST | None] | None:
    """("send" | "recv", the peer expression) of a point-to-point call."""
    leaf = _dist_call(node)
    if leaf == "P2POp":
        if not node.args:
            return None
        kind = _leaf(call_name(ast.Call(func=node.args[0], args=[], keywords=[])))
        peer = node.args[2] if len(node.args) > 2 else None
    elif leaf in SENDS | RECVS:
        kind = leaf
        peer = node.args[1] if len(node.args) > 1 else None
    else:
        return None
    for kw in node.keywords:
        if kw.arg in PEER_KEYWORDS:
            peer = kw.value
    if kind in SENDS:
        return "send", peer
    if kind in RECVS:
        return "recv", peer
    return None


def _ring_term(peer: ast.AST) -> tuple[str, int, str, str | None] | None:
    """(base, sign, offset, modulus) of `(base +/- offset) % n` or of
    `base +/- offset` (modulus None) where base reads the rank."""
    mod = None
    if isinstance(peer, ast.BinOp) and isinstance(peer.op, ast.Mod):
        mod, peer = ast.dump(peer.right), peer.left
    if not (isinstance(peer, ast.BinOp) and isinstance(peer.op, (ast.Add, ast.Sub))):
        return None
    base, off = peer.left, peer.right
    if not _reads_rank(base):
        return None
    sign = 1 if isinstance(peer.op, ast.Add) else -1
    return ast.dump(base), sign, ast.dump(off), mod


def _ppermute(sf: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    for func in _functions(sf.tree):
        ops = [(n, _p2p(n)) for n in ast.walk(func)
               if isinstance(n, ast.Call) and _p2p(n) is not None
               and _enclosing(sf, n, (ast.FunctionDef, ast.AsyncFunctionDef)) is func]
        if not ops:
            continue
        cls = _enclosing(sf, func, ast.ClassDef)
        env = _assignments([func] + ([cls] if cls is not None else []))
        terms = []
        for node, (kind, peer) in ops:
            term = None if peer is None else _ring_term(_resolve(peer, env))
            if term is None:
                continue
            base, sign, off, mod = term
            if mod is None:
                findings.append(_finding(sf, node, "ppermute-perm",
                                         f"the {kind}'s peer rank {'+' if sign > 0 else '-'} d "
                                         "is not taken % n: the last ranks' peer is outside "
                                         "the group"))
                continue
            terms.append((node, kind, base, sign, off, mod))
        unmatched = list(terms)
        for t in terms:
            if t not in unmatched or t[1] != "send":
                continue
            mate = next((u for u in unmatched if u[1] == "recv" and u[2] == t[2]
                         and u[3] == -t[3] and u[4] == t[4] and u[5] == t[5]), None)
            if mate is not None:
                unmatched.remove(t)
                unmatched.remove(mate)
        for node, kind, _, sign, _, _ in unmatched:
            want = "receive from" if kind == "send" else "send to"
            findings.append(_finding(sf, node, "ppermute-perm",
                                     f"this {kind} has no matching {want} (rank "
                                     f"{'-' if sign > 0 else '+'} d) % n over the same n in "
                                     "its set: the ring is not a permutation, and a rank waits "
                                     "for a message no rank sends"))
    return findings


# ---------------------------------------------------------------------------
# collective-branch
# ---------------------------------------------------------------------------
class _Calls:
    """The ordered collectives a statement list issues, same-file functions
    (by name) and methods (`self.name`) expanded `_EXPAND_DEPTH` deep."""

    def __init__(self, sf: SourceFile):
        self.defs: dict[str, ast.AST] = {}
        for f in _functions(sf.tree):
            cls = _enclosing(sf, f, ast.ClassDef)
            self.defs.setdefault(f"self.{f.name}" if cls is not None else f.name, f)

    def of(self, stmts, depth: int = _EXPAND_DEPTH) -> list[str]:
        out: list[str] = []
        calls = sorted((n for s in stmts for n in ast.walk(s) if isinstance(n, ast.Call)),
                       key=lambda n: (n.lineno, n.col_offset))
        for node in calls:
            leaf = _dist_call(node)
            if leaf is not None:
                out.append(leaf)
                continue
            target = self.defs.get(call_name(node) or "")
            if target is not None and depth > 0:
                out.extend(self.of(target.body, depth - 1))
        return out


def _branches(sf: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    calls = _Calls(sf)
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.If) or not _reads_rank(node.test):
            continue
        body, orelse = calls.of(node.body), calls.of(node.orelse)
        if body != orelse:
            one = body or orelse
            findings.append(_finding(sf, node, "collective-branch",
                                     f"collectives {body} on one arm and {orelse} on the other "
                                     "of a test that reads the rank: the ranks that take the "
                                     f"other arm never enter {one[0] if one else 'them'} "
                                     "(a deadlock)"))
    return findings


# ---------------------------------------------------------------------------
# collective-axis
# ---------------------------------------------------------------------------
def _strings(node: ast.AST | None, env: dict[str, list[ast.AST]], depth: int = _RESOLVE_DEPTH
             ) -> set[str] | None:
    """The string constants `node` may hold, None where it holds something
    this pass cannot see."""
    if node is None or depth < 0:
        return None
    if isinstance(node, ast.Constant):
        return {node.value} if isinstance(node.value, str) else set()
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out: set[str] = set()
        for e in node.elts:
            s = _strings(e, env, depth)
            if s is None:
                return None
            out |= s
        return out
    if isinstance(node, ast.IfExp):
        a, b = _strings(node.body, env, depth), _strings(node.orelse, env, depth)
        return None if a is None or b is None else a | b
    key = _key(node)
    if key is not None and env.get(key):
        out = set()
        for value in env[key]:
            s = _strings(value, env, depth - 1)
            if s is None:
                return None
            out |= s
        return out
    return None


def declared_dims(sf: SourceFile) -> set[str]:
    """The mesh dims this file declares (`init_device_mesh`/`DeviceMesh`'s
    `mesh_dim_names`)."""
    env = _assignments([sf.tree])
    out: set[str] = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call) and _leaf(call_name(node)) in MESH_CTORS:
            for kw in node.keywords:
                if kw.arg == "mesh_dim_names":
                    out |= _strings(kw.value, env) or set()
    return out


def _dim_uses(node: ast.AST):
    """(node, the dim expression) of a use of a mesh dim by name."""
    if isinstance(node, ast.Subscript):
        owner = _leaf(call_name(ast.Call(func=node.value, args=[], keywords=[])))
        if owner and "mesh" in owner.lower():
            yield node, node.slice
    if isinstance(node, ast.Call):
        if _leaf(call_name(node)) in DIM_METHODS and node.args:
            yield node, node.args[0]
        for kw in node.keywords:
            if kw.arg == "mesh_dim":
                yield node, kw.value


def _axes(sf: SourceFile, declared: set[str]) -> list[Finding]:
    if not declared:
        return []
    env = _assignments([sf.tree])
    findings: list[Finding] = []
    for node in ast.walk(sf.tree):
        for at, expr in _dim_uses(node):
            names = _strings(expr, env)
            for name in sorted((names or set()) - declared):
                findings.append(_finding(sf, at, "collective-axis",
                                         f"mesh dim {name!r} is declared by no "
                                         "init_device_mesh(..., mesh_dim_names=...) of the "
                                         f"tree (declared: {sorted(declared)})"))
    return findings


def _finding(sf: SourceFile, node: ast.AST, rule: str, message: str) -> Finding:
    return Finding(path=sf.rel, line=node.lineno, col=node.col_offset, rule=rule,
                   scope=scope_of(sf, node), message=message)


def run(sf: SourceFile) -> list[Finding]:
    """The three rules over one file; collective-axis against the dims the
    whole linted tree declares (`sf.mesh_dims`, set by the CLI), else this
    file's own."""
    declared = getattr(sf, "mesh_dims", None)
    if declared is None:
        declared = declared_dims(sf)
    return _ppermute(sf) + _branches(sf) + _axes(sf, declared)
