"""Pass 7 -- the CUDA kernels and their launchers (``cuda-*``).

The counterpart of `repro/analysis/pallas.py`, which checks Pallas kernels
for what Mosaic cannot lower. The port's kernels are hand-written CUDA C++
(`csrc/`), built with nvcc and called through ctypes (`kernels/build.py`)
by the wrappers of `kernels/ops.py`, whose rules are: the same bits from
every run, a launch on its tensor's card, every launch's error checked,
and no fallback that hides the card or the kernel. Five rules:

* **cuda-float-atomic** (``.cu``/``.cuh``, comments stripped) -- an
  ``atomicAdd``, ``atomicSub``, ``atomicExch``, ``atomicMax``,
  ``atomicMin`` or ``atomicCAS`` (and their ``_block``/``_system``
  forms) whose target's base name (the first argument without ``&``,
  casts and indexing) is not declared with an integer type in the same
  file (the nearest declaration before the call, else the first after;
  none counts as not integer), or an inline-PTX ``red.``/``atom.`` in an
  ``asm`` string whose type is not integer (``.u``, ``.s``, ``.b``). A
  float atomic's order, and so its rounding, changes from run to run.
  An integer counter in shared memory (`csrc/topn.cu`'s histogram and
  output cursor) is exact in any order and stays clean.

* **cuda-launch-guard** -- a call to a ``*_launch`` function of a
  ``library(...)`` object (`kernels/build.py::library`, directly or
  through a name bound to one in an enclosing function) that is not
  lexically inside ``with _on_card(...)`` in its own function: the
  launchers size their grids and shared memory for the current card, so
  a launch for cuda:1 while cuda:0 is current is wrong (`ops._on_card`).

* **cuda-launch-check** -- such a launcher call whose return value does
  not reach a ``check(...)`` of the build module (``build.check``,
  ``<x>.build_mod.check``, a bare ``check``) in the same function: passed
  to it directly, or bound to a name passed to it on a later line. A
  launch error left unchecked surfaces, if ever, in a later kernel.

* **cuda-fallback** -- in `kernels/ops.py` and `kernels/build.py`: an
  ``except`` handler that neither re-raises nor raises (it swallows the
  error: a build or a launch that failed goes on as if it had not), and a
  call into ``ref.*`` (the plain versions) that is not guarded by the
  test ``not _on_cuda(...)``, ``_on_cuda(...) is False`` or ``==
  False``, or by the ``else`` of ``if _on_cuda(...)``. The plain version
  runs only for a tensor on the CPU.

* **cuda-spill** -- reads the ptxas output that `kernels/build.py`
  collects (``-Xptxas -v``; `build.ptxas_log`) and flags every kernel
  entry with non-zero spill stores or loads. It runs only where a log is
  given (``--ptxas SOURCE=LOG``, or `spill_findings`), so only where nvcc
  ran. Its findings are keyed by the kernel's source and the demangled
  entry, so a spill a kernel is known to take goes into the baseline with
  its reason.
"""
from __future__ import annotations

import ast
import os
import re
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

from repro_torch.analysis.common import (CudaSource, Finding, SourceFile,
                                         call_name, dotted_name, scope_of)

RULES = ("cuda-float-atomic", "cuda-launch-guard", "cuda-launch-check",
         "cuda-fallback", "cuda-spill")

# ---------------------------------------------------------------------------
# cuda-float-atomic
# ---------------------------------------------------------------------------
_ATOMIC_RE = re.compile(r"\b(atomic(?:Add|Sub|Exch|Max|Min|CAS)(?:_block|_system)?)\s*\(")
_PTX_RE = re.compile(r"\b(?:red|atom)((?:\.[A-Za-z0-9_]+)+)")
_STRING_RE = re.compile(r'"[^"\n]*"')
_IDENT_RE = re.compile(r"(?<!\w)[A-Za-z_]\w*")
_PTX_TYPE_RE = re.compile(r"^(?:(?:u|s|b|f|bf)\d+|e[45]m[23])(?:x\d+)?$")

INTEGER_WORDS = frozenset({
    "int", "unsigned", "signed", "long", "short", "char", "bool", "size_t",
    "ssize_t", "ptrdiff_t", "uint", "int8_t", "int16_t", "int32_t", "int64_t",
    "uint8_t", "uint16_t", "uint32_t", "uint64_t", "intptr_t", "uintptr_t",
})
QUALIFIERS = frozenset({
    "const", "volatile", "static", "extern", "register", "constexpr", "inline",
    "__shared__", "__device__", "__constant__", "__managed__", "__restrict__",
    "restrict", "__forceinline__", "__align__", "struct", "std",
})
_CASTS = frozenset({"reinterpret_cast", "static_cast", "const_cast"})
_NOT_TYPES = frozenset({
    "return", "else", "case", "goto", "throw", "new", "delete", "sizeof", "if",
    "while", "for", "do", "switch", "typedef", "using", "namespace", "template",
    "typename", "asm",
})
_SCAN_CHARS = frozenset("*&:<> \t\n")
_DELIMS = frozenset(";{}(),")


def _code_without_directives(code: str) -> str:
    """`code` with preprocessor lines (and their continuations) blanked."""
    out = []
    cont = False
    for line in code.split("\n"):
        if cont or line.lstrip().startswith("#"):
            cont = line.rstrip().endswith("\\")
            out.append(" " * len(line))
        else:
            out.append(line)
    return "\n".join(out)


def _first_arg(code: str, open_pos: int) -> str:
    depth = 0
    for i in range(open_pos + 1, len(code)):
        c = code[i]
        if c in "([{":
            depth += 1
        elif c in ")]}":
            if depth == 0:
                return code[open_pos + 1:i]
            depth -= 1
        elif c == "," and depth == 0:
            return code[open_pos + 1:i]
    return code[open_pos + 1:]


def _base_name(expr: str) -> str | None:
    """The variable an atomic's address expression points into: its first
    identifier that is not a cast or a type word."""
    for word in _IDENT_RE.findall(expr):
        if word in _CASTS or word in INTEGER_WORDS or word in QUALIFIERS \
                or word in ("float", "double", "half", "__half", "__nv_bfloat16"):
            continue
        return word
    return None


def _type_words(prefix: str) -> list[str] | None:
    words = _IDENT_RE.findall(prefix)
    if not words or any(w in _NOT_TYPES for w in words):
        return None
    return [w for w in words if w not in QUALIFIERS]


def _declarator_list_type(code: str, comma: int) -> list[str] | None:
    """The type of the declarator list a `, name` belongs to: the words
    before the list's first declarator, when the statement is one."""
    depth, i = 0, comma - 1
    while i >= 0:
        c = code[i]
        if c in ")]":
            depth += 1
        elif c in "([":
            if depth == 0:
                return None          # an argument list, not a declaration
            depth -= 1
        elif c in ";{}" and depth == 0:
            break
        i -= 1
    first = re.match(r"\s*((?:[A-Za-z_]\w*[\s*&]+)+?)[\s*&]*[A-Za-z_]\w*\s*(?:\[[^\]]*\]\s*)*"
                     r"(?:=[^,]*)?,", code[i + 1:comma + 1], re.S)
    if first is None:
        return None
    return _type_words(first.group(1))


def declarations(code: str, name: str) -> list[tuple[int, list[str]]]:
    """(position, type words without qualifiers) of each declaration of
    `name` in comment-, string- and directive-free CUDA code."""
    out = []
    for m in re.finditer(rf"\b{re.escape(name)}\b", code):
        after = code[m.end():].lstrip()[:1]
        if after not in ("[", ";", "=", ",", ")"):
            continue
        j = m.start() - 1
        while j >= 0 and (code[j].isalnum() or code[j] == "_" or code[j] in _SCAN_CHARS):
            j -= 1
        delim = code[j] if j >= 0 else ";"
        if delim not in _DELIMS:
            continue
        words = _type_words(code[j + 1:m.start()])
        if words is None and delim == "," and not code[j + 1:m.start()].strip(" \t\n*&"):
            words = _declarator_list_type(code, j)
        if words:
            out.append((m.start(), words))
    return out


def is_integer(words: list[str]) -> bool:
    return bool(words) and all(w in INTEGER_WORDS for w in words)


def _atomic_findings(cs: CudaSource) -> list[Finding]:
    code = _code_without_directives(cs.code)
    findings = []
    for m in _ATOMIC_RE.finditer(code):
        open_pos = m.end() - 1
        target = _base_name(_first_arg(code, open_pos))
        if target is None:
            continue
        decls = declarations(code, target)
        before = [d for d in decls if d[0] < m.start()]
        decl = before[-1] if before else (decls[0] if decls else None)
        if decl is not None and is_integer(decl[1]):
            continue
        what = (f"declared as '{' '.join(decl[1])}'" if decl is not None
                else "not declared in this file")
        findings.append(Finding(
            path=cs.rel, line=cs.line_of(m.start()), col=cs.col_of(m.start()),
            rule="cuda-float-atomic", scope=m.group(1),
            message=(f"{m.group(1)} on '{target}' ({what}): an atomic on a value that "
                     "is not an integer adds in the order threads arrive, so its "
                     "result changes from run to run -- sum in a fixed order"),
        ))
    for lit in _STRING_RE.finditer(cs.code_strings):
        for m in _PTX_RE.finditer(lit.group(0)):
            types = [p for p in m.group(1).split(".")[1:] if _PTX_TYPE_RE.match(p)]
            if types and types[-1][0] in "usb" and not types[-1].startswith("bf"):
                continue
            pos = lit.start() + m.start()
            findings.append(Finding(
                path=cs.rel, line=cs.line_of(pos), col=cs.col_of(pos),
                rule="cuda-float-atomic", scope="asm",
                message=(f"inline PTX '{m.group(0)}' is an atomic or reduction on a "
                         "type that is not an integer -- its order, and so its "
                         "rounding, changes from run to run"),
            ))
    return findings


def run_cuda(cs: CudaSource) -> list[Finding]:
    return _atomic_findings(cs)


# ---------------------------------------------------------------------------
# launch-guard, launch-check, fallback (the Python launchers)
# ---------------------------------------------------------------------------
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
FALLBACK_FILES = ("kernels/ops.py", "kernels/build.py")


def _leaf(name: str | None) -> str | None:
    return name.rsplit(".", 1)[-1] if name else None


def _function_of(sf: SourceFile, node: ast.AST) -> ast.AST:
    cur = sf.parent(node)
    while cur is not None and not isinstance(cur, _FUNCS):
        cur = sf.parent(cur)
    return cur if cur is not None else sf.tree


def _is_library_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and _leaf(call_name(node)) == "library"


def _bound_to_library(sf: SourceFile, use: ast.Name) -> bool:
    """Whether `use` names a library(...) object bound in its function or
    an enclosing one (the nearest scope that binds the name decides)."""
    scope = _function_of(sf, use)
    while True:
        binds = [sub for sub in ast.walk(scope) if isinstance(sub, ast.Assign)
                 and _function_of(sf, sub) is scope
                 and any(isinstance(t, ast.Name) and t.id == use.id for t in sub.targets)]
        if binds:
            return any(_is_library_call(b.value) for b in binds)
        if scope is sf.tree:
            return False
        scope = _function_of(sf, scope)


def launcher_calls(sf: SourceFile) -> list[ast.Call]:
    """Every call of a `*_launch` function of a built kernel's library."""
    out = []
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr.endswith("_launch")):
            continue
        owner = node.func.value
        if _is_library_call(owner) or (isinstance(owner, ast.Name)
                                       and _bound_to_library(sf, owner)):
            out.append(node)
    return out


def _guarded_by_card(sf: SourceFile, node: ast.AST) -> bool:
    cur = sf.parent(node)
    while cur is not None and not isinstance(cur, _FUNCS):
        if isinstance(cur, (ast.With, ast.AsyncWith)) and any(
                isinstance(item.context_expr, ast.Call)
                and _leaf(call_name(item.context_expr)) == "_on_card"
                for item in cur.items):
            return True
        cur = sf.parent(cur)
    return False


def _is_check(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = call_name(node)
    if name == "check":
        return True
    return (name is not None and name.endswith(".check")
            and "build" in name.rsplit(".", 2)[-2])


def _checked(sf: SourceFile, call: ast.Call) -> bool:
    parent = sf.parent(call)
    if _is_check(parent) and call in parent.args:
        return True
    if not (isinstance(parent, ast.Assign) and len(parent.targets) == 1
            and isinstance(parent.targets[0], ast.Name)):
        return False
    err = parent.targets[0].id
    scope = _function_of(sf, call)
    return any(_is_check(sub) and sub.lineno >= parent.lineno
               and any(isinstance(a, ast.Name) and a.id == err for a in sub.args)
               for sub in ast.walk(scope))


def _on_cuda_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and _leaf(call_name(node)) == "_on_cuda"


def _cpu_test(test: ast.AST) -> bool | None:
    """True when `test` holds only for a CPU tensor, False when only for a
    CUDA one, None when it says neither."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
            and _on_cuda_call(test.operand):
        return True
    if _on_cuda_call(test):
        return False
    if (isinstance(test, ast.Compare) and _on_cuda_call(test.left)
            and len(test.ops) == 1 and isinstance(test.ops[0], (ast.Is, ast.Eq))
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is False):
        return True
    return None


def _guarded_to_cpu(sf: SourceFile, node: ast.AST) -> bool:
    child, cur = node, sf.parent(node)
    while cur is not None and not isinstance(cur, _FUNCS):
        if isinstance(cur, (ast.If, ast.IfExp)):
            cpu = _cpu_test(cur.test)
            body = cur.body if isinstance(cur, ast.If) else [cur.body]
            orelse = cur.orelse if isinstance(cur, ast.If) else [cur.orelse]
            if (cpu is True and child in body) or (cpu is False and child in orelse):
                return True
        child, cur = cur, sf.parent(cur)
    return False


def _raises(handler: ast.ExceptHandler) -> bool:
    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNCS + (ast.ClassDef,)):
                continue
            yield child
            yield from walk(child)
    return any(isinstance(n, ast.Raise) for n in walk(handler))


def run(sf: SourceFile) -> list[Finding]:
    findings: list[Finding] = []

    def add(node, rule, message):
        findings.append(Finding(path=sf.rel, line=node.lineno, col=node.col_offset,
                                rule=rule, scope=scope_of(sf, node), message=message))

    for call in launcher_calls(sf):
        fn = call.func.attr
        if not _guarded_by_card(sf, call):
            add(call, "cuda-launch-guard",
                f"'{fn}' is not inside 'with _on_card(...)' -- the launcher sizes its "
                "grid and shared memory for the current card, which need not be "
                "the tensors' card")
        if not _checked(sf, call):
            add(call, "cuda-launch-check",
                f"the error '{fn}' returns does not reach build.check(...) in this "
                "function -- a failed launch would go unnoticed")
    if sf.rel.endswith(FALLBACK_FILES):
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ExceptHandler) and not _raises(node):
                add(node, "cuda-fallback",
                    "this except handler swallows the error -- a kernel that failed "
                    "to build or launch must raise, never fall back")
            elif (isinstance(node, ast.Call)
                  and (dotted_name(node.func) or "").startswith("ref.")
                  and not _guarded_to_cpu(sf, node)):
                add(node, "cuda-fallback",
                    f"'{dotted_name(node.func)}' (a plain version) is not guarded by "
                    "'not _on_cuda(...)' -- the plain version runs only for a tensor "
                    "on the CPU")
    return findings


# ---------------------------------------------------------------------------
# cuda-spill (ptxas -v output)
# ---------------------------------------------------------------------------
@dataclass
class PtxasEntry:
    """One kernel entry's resources as ptxas reports them."""

    name: str
    registers: int = 0
    spill_stores: int = 0
    spill_loads: int = 0
    smem: int = 0            # static shared memory, bytes
    stack: int = 0           # stack frame, bytes


_ENTRY_RE = re.compile(r"Compiling entry function '([^']+)'")
_PROPS_RE = re.compile(r"Function properties for (\S+)")
_FRAME_RE = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads")
_USED_RE = re.compile(r"Used (\d+) registers")
_SMEM_RE = re.compile(r"(\d+) bytes smem")


def ptxas_entries(log: str) -> list[PtxasEntry]:
    """The kernel entries of one nvcc run's ptxas -v output, in order."""
    entries: dict[str, PtxasEntry] = {}
    current = props = None
    for line in log.splitlines():
        if m := _ENTRY_RE.search(line):
            current = entries.setdefault(m.group(1), PtxasEntry(m.group(1)))
        elif m := _PROPS_RE.search(line):
            props = entries.get(m.group(1))
        elif (m := _FRAME_RE.search(line)) and props is not None:
            props.stack, props.spill_stores, props.spill_loads = map(int, m.groups())
        elif (m := _USED_RE.search(line)) and current is not None:
            current.registers = int(m.group(1))
            if s := _SMEM_RE.search(line):
                current.smem = int(s.group(1))
    return list(entries.values())


def demangler():
    """A function from mangled entry names to readable ones, by the CUDA
    toolkit's cu++filt (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin), or
    None where there is none."""
    found = shutil.which("cu++filt")
    if found is None:
        for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
            if home and (Path(home) / "bin" / "cu++filt").exists():
                found = str(Path(home) / "bin" / "cu++filt")
                break
    if found is None:
        return None

    def demangle(names: list[str]) -> dict[str, str]:
        if not names:
            return {}
        out = subprocess.run([found, "-p", *names], capture_output=True, text=True,
                             check=True)
        return {n: t.replace("<unnamed>::", "").replace("(int)", "").strip()
                for n, t in zip(names, out.stdout.splitlines())}
    return demangle


def spill_findings(log: str, path: str, demangle=None) -> list[Finding]:
    """A cuda-spill finding for each entry of `log` that spills; `path` is
    the kernel's source and `demangle` (names -> {name: readable}) names
    the entries."""
    entries = ptxas_entries(log)
    names = demangle([e.name for e in entries]) if demangle else {}
    return [Finding(
        path=path, line=0, col=0, rule="cuda-spill", scope=names.get(e.name, e.name),
        message=(f"{e.spill_stores} bytes spill stores, {e.spill_loads} bytes spill "
                 f"loads at {e.registers} registers -- the kernel keeps live values "
                 "in local memory"),
    ) for e in entries if e.spill_stores or e.spill_loads]
