"""The port's lint (`python -m repro_torch.analysis`): a positive and a
negative fixture for each of its sixteen rules, a mutant of a live file for
each of the nine rules that guard the port's own faults (each flagged by
its rule and by no other, the unmutated file clean), collective-axis over a
tree whose mesh declaration is mutated, cuda-spill on recorded
ptxas output, the CLI's exit codes, JSON report and baseline round trip,
that the analyzer imports only the standard library, and the meta-test:
the live tree is clean against the checked-in baseline, which holds only
the flash forward's recorded spill.

Stdlib and pytest only (no torch line: nothing here imports torch); the
fixtures live in strings, never as files under src/ or tests/."""
import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import ALL_RULES, RULE_DOCS, analyze_source, main
from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.cli import PASSES, analyze_ptxas
from repro_torch.analysis.cuda import ptxas_entries, spill_findings

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def src(code: str) -> str:
    return textwrap.dedent(code).lstrip("\n")


def rules_of(findings):
    return [f.rule for f in findings]


# ---------------------------------------------------------------------------
# fixtures: rule -> (file name, positive code, negative code)
# ---------------------------------------------------------------------------
GUARDED = src("""
    import threading

    class Coord:
        def __init__(self):
            self._lock = threading.Lock()
            self.epoch = 0

        def commit(self):
            with self._lock:
                self.epoch += 1

        def peek(self):
            return self.epoch
""")

LOCKED_CALL = src("""
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()

        def _pick_locked(self):
            return 1

        def good(self):
            with self._lock:
                return self._pick_locked()

        def bad(self):
            return self._pick_locked()
""")

REACQUIRE = src("""
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()

        def _step_locked(self):
            with self._lock:
                return 1
""")

SYNC = src("""
    import torch

    class Host:
        def __init__(self):
            self._lock = threading.Lock()
            self.tables = None

        def adopt(self, ens, t):
            with self._lock:
                self.tables = ens.scoring_matrices()
                n = t.sum().item()
                z = torch.zeros(3)
                t.cpu()
                t.to("cuda")
                torch.cuda.synchronize()
""")

SYNC_CLEAN = src("""
    import torch

    class Host:
        def __init__(self):
            self._lock = threading.Lock()
            self.tables = None

        def adopt(self, ens, t):
            tables = ens.scoring_matrices()     # staged off the lock
            n = t.sum().item()
            with self._lock:
                self.tables = tables            # the flip is a pointer swap
                def later():
                    return t.cpu()              # runs later, not under it
            return later
""")

RNG = src("""
    import torch

    def init(m, k, device):
        torch.manual_seed(0)
        u = torch.randn((m, k), device=device)
        w = torch.empty(k).normal_()
        return u, w
""")

RNG_CLEAN = src("""
    import torch

    def init(m, k, device, generator):
        g = torch.Generator(device=device).manual_seed(0)
        u = torch.randn((m, k), generator=g, device=device)
        w = torch.empty(k).normal_(generator=generator)
        kw = dict(generator=generator, device=device)
        v = torch.randn((m, k), **kw)
        return u, v, w
""")

SUMS = src("""
    import torch

    def stats(rows, seg, n, w):
        out = torch.zeros(n, rows.shape[1]).index_add_(0, seg, rows)
        acc = torch.zeros(n).index_put_((seg,), w, accumulate=True)
        cnt = torch.bincount(seg, weights=w)
        return out, acc, cnt
""")

SUMS_CLEAN = src("""
    import numpy as np
    import torch

    def stats(rows, offsets, seg, w):
        out = torch.segment_reduce(rows, "sum", offsets=offsets, axis=0)
        cnt = np.bincount(seg, weights=w)                 # host numpy
        last = torch.full((4,), -1).scatter_reduce_(0, seg, w, "amax")
        put = torch.zeros(4).index_put_((seg,), w)        # no accumulate
        return out, cnt, last, put
""")

PPERMUTE = src("""
    import torch.distributed as dist

    def forward(x, buf, group):
        rank, n = dist.get_rank(group), dist.get_world_size(group)
        ops = [dist.P2POp(dist.isend, x, group=group, group_peer=(rank + 1) % n),
               dist.P2POp(dist.irecv, buf, group=group, group_peer=(rank + 1) % n)]
        return dist.batch_isend_irecv(ops)
""")
PPERMUTE_CLEAN = PPERMUTE.replace("dist.irecv, buf, group=group, group_peer=(rank + 1) % n",
                                  "dist.irecv, buf, group=group, group_peer=(rank - 1) % n")

BRANCH = src("""
    import torch.distributed as dist

    def save(t, rank, write):
        if rank == 0:
            dist.barrier()
            write(t)
""")
BRANCH_CLEAN = src("""
    import torch.distributed as dist

    def save(t, rank, write):
        dist.barrier()
        if rank == 0:
            write(t)
""")

AXIS = src("""
    from torch.distributed.device_mesh import init_device_mesh

    def make():
        return init_device_mesh("cpu", (4,), mesh_dim_names=("items",))

    def group(mesh):
        return mesh.get_group("item")
""")
AXIS_CLEAN = AXIS.replace('get_group("item")', 'get_group("items")')

TF32 = src("""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
""")

TF32_CLEAN = src("""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
""")

LOOPS = src("""
    import torch

    def chain(xs, n):
        out = []
        for x in xs:
            out.append(x.sum().item())
        while xs[0].max().item() > 0:
            xs = xs[1:]
        return out, [x.cpu() for x in xs]
""")

LOOPS_CLEAN = src("""
    import torch

    def chain(xs, n):
        for i in xs.tolist():                 # the iterable runs once
            n += i
        total = torch.stack(xs).sum().item()  # one sync after the loop
        for x in xs:
            def later():
                return x.item()               # not the loop's
        return n, total, later
""")

ATOMIC = src("""
    __global__ void add(const float* __restrict__ x, float* __restrict__ out, int n) {
      const int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) atomicAdd(&out[i % 7], x[i]);
    }
""")

ATOMIC_CLEAN = src("""
    // atomicAdd(&out[0], 1.0f) in a comment is not code
    __global__ void count(const float* __restrict__ x, int* __restrict__ hist, int n) {
      __shared__ int sel_digit, sel_rem, n_out;
      __shared__ unsigned long long keys[32];
      const int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) atomicAdd(&hist[(int)x[i] & 0xff], 1);
      if (i == 0) atomicAdd(&n_out, 1);
      atomicMax(&keys[i & 31], 1ull);
      asm volatile("red.global.add.u32 [%0], %1;" :: "l"(hist), "r"(1));
    }
""")

LAUNCH = src("""
    from repro_torch.kernels import build

    def _masked_syrk(vm, rv, prec, rhs, r, w, k):
        lib = build.library("masked_syrk")
        err = lib.masked_syrk_launch(vm.data_ptr(), rv.data_ptr(), prec.data_ptr(),
                                     rhs.data_ptr(), r, w, k, 8, _stream(vm))
        build.check("masked_syrk", err)
""")

LAUNCH_CLEAN = src("""
    from repro_torch.kernels import build

    def _masked_syrk(vm, rv, prec, rhs, r, w, k):
        lib = build.library("masked_syrk")
        with _on_card(vm):
            err = lib.masked_syrk_launch(vm.data_ptr(), rv.data_ptr(), prec.data_ptr(),
                                         rhs.data_ptr(), r, w, k, 8, _stream(vm))
        build.check("masked_syrk", err)
""")

UNCHECKED = LAUNCH_CLEAN.replace('    build.check("masked_syrk", err)\n', "")

FALLBACK = src("""
    from repro_torch.kernels import build, ref

    def _topn(u, v, k):
        try:
            return _launch(u, v, k)
        except RuntimeError:
            pass
        return ref.topn_scores_ref(u, v, k)
""")

FALLBACK_CLEAN = src("""
    from repro_torch.kernels import build, ref

    def _topn(u, v, k):
        if not _on_cuda(u):
            return ref.topn_scores_ref(u, v, k)
        try:
            return _launch(u, v, k)
        except RuntimeError as e:
            raise RuntimeError("topn failed") from e

    def _flash(q):
        if _on_cuda(q):
            return _launch(q)
        else:
            return ref.flash_attention_ref(q)
""")

OPS = "src/repro_torch/kernels/ops.py"

FIXTURES = {
    "guarded-field": ("mod.py", GUARDED, GUARDED.replace(
        "    def peek(self):\n        return self.epoch",
        "    def peek(self):\n        with self._lock:\n            return self.epoch")),
    "locked-call": ("mod.py", LOCKED_CALL, LOCKED_CALL.replace(
        "    def bad(self):\n        return self._pick_locked()",
        "    def bad_locked(self):\n        return self._pick_locked()")),
    "lock-reacquire": ("mod.py", REACQUIRE, REACQUIRE.replace(
        "threading.Lock()", "threading.RLock()")),
    "sync-under-lock": ("src/repro_torch/serve/mod.py", SYNC, SYNC_CLEAN),
    "rng-global": ("src/repro_torch/core/mod.py", RNG, RNG_CLEAN),
    "ordered-sum": ("src/repro_torch/core/mod.py", SUMS, SUMS_CLEAN),
    "ppermute-perm": ("src/repro_torch/core/mod.py", PPERMUTE, PPERMUTE_CLEAN),
    "collective-branch": ("src/repro_torch/core/mod.py", BRANCH, BRANCH_CLEAN),
    "collective-axis": ("src/repro_torch/core/mod.py", AXIS, AXIS_CLEAN),
    "tf32": ("src/repro_torch/device.py", TF32, TF32_CLEAN),
    "host-sync-in-loop": ("src/repro_torch/models/mod.py", LOOPS, LOOPS_CLEAN),
    "cuda-float-atomic": ("src/repro_torch/csrc/k.cu", ATOMIC, ATOMIC_CLEAN),
    "cuda-launch-guard": (OPS, LAUNCH, LAUNCH_CLEAN),
    "cuda-launch-check": (OPS, UNCHECKED, LAUNCH_CLEAN),
    "cuda-fallback": (OPS, FALLBACK, FALLBACK_CLEAN),
}

#: how many findings each positive fixture holds
POSITIVE_COUNT = {"guarded-field": 1, "locked-call": 1, "lock-reacquire": 1,
                  "sync-under-lock": 6, "rng-global": 3, "ordered-sum": 3,
                  "ppermute-perm": 2, "collective-branch": 1, "collective-axis": 1, "tf32": 2,
                  "host-sync-in-loop": 3, "cuda-float-atomic": 1,
                  "cuda-launch-guard": 1, "cuda-launch-check": 1, "cuda-fallback": 2,
                  "cuda-spill": 1}

PTXAS_SPILL = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z12flash_kernelILi256EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z12flash_kernelILi256EEvPKf
    24 bytes stack frame, 20 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 24 bytes cumulative stack size, 33792 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z12flash_kernelILi64EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z12flash_kernelILi64EEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16384 bytes smem, 400 bytes cmem[0]
"""
PTXAS_CLEAN = PTXAS_SPILL.replace("20 bytes spill stores, 20 bytes spill loads",
                                  "0 bytes spill stores, 0 bytes spill loads")
FLASH_CU = "src/repro_torch/csrc/flash_attention.cu"


def _findings(rule: str, which: int):
    if rule == "cuda-spill":
        log = (PTXAS_SPILL, PTXAS_CLEAN)[which - 1]
        return [f for f, _ in analyze_ptxas({FLASH_CU: log})]
    name, *codes = FIXTURES[rule]
    return analyze_source(codes[which - 1], filename=name)


@pytest.mark.parametrize("rule", ALL_RULES)
def test_positive_fixture_is_flagged_by_its_rule_alone(rule):
    found = _findings(rule, 1)
    assert rules_of(found) == [rule] * POSITIVE_COUNT[rule], found


@pytest.mark.parametrize("rule", ALL_RULES)
def test_negative_fixture_is_clean(rule):
    assert _findings(rule, 2) == []


def test_every_pass_rule_is_documented_and_has_fixtures():
    implemented = {r for mod in PASSES for r in mod.RULES}
    assert implemented == set(RULE_DOCS) == set(ALL_RULES) == set(POSITIVE_COUNT)
    assert len(ALL_RULES) == 16
    assert set(FIXTURES) | {"cuda-spill"} == set(ALL_RULES)


# ---------------------------------------------------------------------------
# the rules' edges
# ---------------------------------------------------------------------------
def test_sync_under_lock_reads_the_lock_by_name_and_honours_the_directive():
    code = src("""
        class C:
            def f(self, ens, t):
                with self._lock:
                    a = ens.scoring_matrices()
                    b = t.cpu()
                    c = torch.zeros(3)
                    d = t.to('cuda')  # repro-lint: disable=sync-under-lock (stop-the-world)
                    self.n += 1
                e = t.item()
                with self.timer:
                    f = t.item()
    """)
    assert [f.line for f in analyze_source(code, rules=["sync-under-lock"])] == [4, 5, 6]


def test_sync_under_lock_in_a_locked_method():
    code = src("""
        class C:
            def _commit_locked(self, t):
                return t.tolist()
    """)
    (f,) = analyze_source(code, rules=["sync-under-lock"])
    assert f.scope == "C._commit_locked" and "self._lock" in f.message


def test_rng_global_forwarded_kw_counts_only_a_local_dict_with_a_generator():
    code = src("""
        import torch

        def a(kw):
            return torch.randn(3, **kw)              # not bound here

        def b(g):
            kw = {"generator": g, "device": "cpu"}
            return torch.rand(3, **kw)

        def c(dev):
            kw = dict(device=dev)
            return torch.randint(0, 9, (3,), **kw)   # no generator in it
    """)
    assert [f.line for f in analyze_source(code, rules=["rng-global"])] == [4, 12]


@pytest.mark.parametrize("call", ["torch.cuda.manual_seed(1)", "torch.cuda.manual_seed_all(1)",
                                  "torch.random.manual_seed(1)", "torch.randperm(9)",
                                  "torch.multinomial(p, 2)", "torch.bernoulli(p)",
                                  "torch.randn_like(p)", "torch.nn.init.uniform_(p)",
                                  "p.exponential_()", "p.random_(0, 9)"])
def test_rng_global_catches_each_global_draw(call):
    (f,) = analyze_source(f"import torch\nx = {call}\n", rules=["rng-global"])
    assert f.rule == "rng-global"


@pytest.mark.parametrize("call", ["x.index_add(0, i, r)", "torch.index_add(x, 0, i, r)",
                                  "x.scatter_add_(0, i, r)", "x.scatter_reduce_(0, i, r, 'sum')",
                                  "x.index_reduce_(0, i, r, 'prod')",
                                  "torch.index_put(x, (i,), r, True)",
                                  "x.put_(i, r, accumulate=True)", "i.bincount(r)"])
def test_ordered_sum_catches_each_atomic_scatter(call):
    (f,) = analyze_source(f"import torch\ny = {call}\n", rules=["ordered-sum"])
    assert f.rule == "ordered-sum"


def test_host_sync_in_loop_only_in_core_models_kernels():
    assert analyze_source(LOOPS, filename="src/repro_torch/serve/mod.py") == []
    assert analyze_source(LOOPS, filename="tests/test_torch_x.py") == []
    for d in ("core", "models", "kernels"):
        assert len(analyze_source(LOOPS, filename=f"src/repro_torch/{d}/m.py")) == 3


def test_float_atomic_reads_declarations_and_ptx_types():
    code = src("""
        template <typename T>
        __global__ void k(T* __restrict__ acc, double* __restrict__ d, unsigned* u) {
          extern __shared__ float sm[];
          atomicAdd(&acc[0], (T)1);
          atomicCAS(reinterpret_cast<unsigned long long*>(d), 0ull, 1ull);
          atomicAdd(&sm[threadIdx.x], 1.0f);
          atomicExch(undeclared, 1);
          atomicAdd(u, 1u);
          asm volatile("red.global.add.f32 [%0], %1;" :: "l"(d), "f"(1.0f));
          asm volatile("atom.global.add.noftz.bf16x2 %0, [%1], %2;" : "=r"(r) : "l"(d), "r"(1));
        }
    """)
    found = analyze_source(code, filename="k.cu")
    assert [f.line for f in found] == [4, 5, 6, 7, 9, 10]
    assert "declared as 'T'" in found[0].message and "not declared" in found[3].message


def test_float_atomic_directive_is_a_line_comment_in_cuda():
    code = ATOMIC.replace("atomicAdd(&out[i % 7], x[i]);",
                          "atomicAdd(&out[i % 7], x[i]);  // repro-lint: disable=cuda-float-atomic")
    assert analyze_source(code, filename="k.cuh") == []
    python_style = ATOMIC.replace("x[i]);", "x[i]);  # repro-lint: disable=cuda-float-atomic")
    assert rules_of(analyze_source(python_style, filename="k.cu")) == ["cuda-float-atomic"]


def test_launch_guard_sees_a_library_bound_in_an_enclosing_function():
    code = src("""
        def timed(self, b):
            lib = self.build_mod.library("gather_syrk_seg")

            def launch():
                err = lib.gather_syrk_seg_launch(b.ptr)
                self.build_mod.check("gather_syrk_seg", err)

            with _on_card(b):
                return launch   # the guard does not cover the call inside launch()
    """)
    (f,) = analyze_source(code, filename="chip_smoke.py")
    assert f.rule == "cuda-launch-guard" and f.line == 5
    # a name bound to something else is no library
    other = code.replace('self.build_mod.library("gather_syrk_seg")', "make()")
    assert analyze_source(other, filename="chip_smoke.py") == []


def test_launch_check_takes_the_error_passed_directly():
    code = src("""
        def go(x):
            with _on_card(x):
                build.check("topn_scores", build.library("topn_scores").topn_scores_launch(x))
            with _on_card(x):
                build.library("topn_scores").topn_scores_launch(x)
    """)
    (f,) = analyze_source(code)
    assert f.rule == "cuda-launch-check" and f.line == 5


def test_fallback_only_in_the_wrappers_and_the_build():
    assert analyze_source(FALLBACK, filename="src/repro_torch/serve/topn.py") == []
    found = analyze_source(FALLBACK, filename="src/repro_torch/kernels/build.py")
    assert rules_of(found) == ["cuda-fallback"] * 2


def test_ptxas_entries_and_spill_keys():
    big, small = ptxas_entries(PTXAS_SPILL)
    assert (big.registers, big.spill_stores, big.spill_loads, big.smem, big.stack) == (
        255, 20, 20, 33792, 24)
    assert (small.registers, small.spill_stores, small.smem) == (128, 0, 16384)
    (f,) = spill_findings(PTXAS_SPILL, FLASH_CU,
                          demangle=lambda names: {n: f"entry{i}" for i, n in enumerate(names)})
    assert (f.path, f.scope) == (FLASH_CU, "entry0")
    assert f.baseline_key() == f"{FLASH_CU}::cuda-spill::entry0::"
    assert spill_findings(PTXAS_CLEAN, FLASH_CU) == []


@pytest.mark.parametrize("peer", ["rank + 1", "dist.get_rank() - 1"])
def test_ppermute_perm_flags_a_peer_not_taken_mod_n(peer):
    code = PPERMUTE_CLEAN.replace("group_peer=(rank + 1) % n", f"group_peer={peer}")
    found = analyze_source(code, filename="src/repro_torch/core/mod.py")
    assert rules_of(found) == ["ppermute-perm"] * 2 and "% n" in found[0].message, found


def test_ppermute_perm_pairs_isend_and_irecv_through_the_class_attributes():
    """Peers set in __init__ as a tuple and read in another method; the
    send and the receive must share the offset and the modulus."""
    code = src("""
        import torch.distributed as dist

        class Ring:
            shift = 1

            def __init__(self, ex):
                n, r = ex.n, ex.rank
                self.dst, self.src = (r + self.shift) % n, (r - self.shift) % n

            def forward(self, x, buf):
                return [dist.isend(x, dst=self.dst), dist.irecv(buf, src=self.src)]
    """)
    assert analyze_source(code, filename="src/repro_torch/core/mod.py") == []
    for wrong in ("(r - self.shift) % (n + 1)", "(r - 2 * self.shift) % n"):
        bad = code.replace("(r - self.shift) % n", wrong)
        assert rules_of(analyze_source(bad, filename="src/repro_torch/core/mod.py")) == [
            "ppermute-perm"] * 2, wrong


def test_collective_branch_expands_same_file_calls_and_reads_the_rank():
    code = src("""
        import torch.distributed as dist

        class Saver:
            def _sync(self):
                dist.all_gather_object([], 0)

            def save(self, t):
                if self.rank == 0:
                    self._sync()
                if t is None:
                    self._sync()
    """)
    found = analyze_source(code, filename="src/repro_torch/core/mod.py")
    assert rules_of(found) == ["collective-branch"] and found[0].line == 8, found


def test_collective_axis_reads_the_whole_tree(tmp_path):
    """A dim one file uses and another declares is clean; after the
    declaration changes the use is flagged (the live exchange against the
    live launcher)."""
    from repro_torch.analysis.cli import analyze_paths

    for rel in ("src/repro_torch/core/exchange.py", "src/repro_torch/launch/mesh.py"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text((ROOT / rel).read_text())
    found, errors = analyze_paths([tmp_path / "src"], tmp_path)
    assert found == [] and errors == []
    mesh = tmp_path / "src/repro_torch/launch/mesh.py"
    text = mesh.read_text()
    assert text.count('mesh_dim_names=("items",)') == 1
    mesh.write_text(text.replace('mesh_dim_names=("items",)', 'mesh_dim_names=("item",)'))
    found, _ = analyze_paths([tmp_path / "src"], tmp_path)
    assert [(f.rule, f.path) for f, _ in found] == [
        ("collective-axis", "src/repro_torch/core/exchange.py")], found


# ---------------------------------------------------------------------------
# mutants of live files: each flagged by its rule and by no other
# ---------------------------------------------------------------------------
def _dedent_block(text: str, first: str, n_lines: int) -> str:
    head, tail = text.split(first, 1)
    lines = (first + tail).split("\n")
    return head + "\n".join([ln[4:] for ln in lines[:n_lines]] + lines[n_lines:])


def _swallowing(text: str) -> str:
    block = ("    with _on_card(vm):\n        err = lib.masked_syrk_launch(\n"
             "            vm.data_ptr(), rv.data_ptr(), prec.data_ptr(), rhs.data_ptr(),\n"
             "            r, w, kp, SYRK_NARROW_MAX_W, _stream(vm),\n        )\n")
    assert text.count(block) == 1
    wrapped = "    try:\n" + textwrap.indent(block, "    ") + (
        "    except Exception:\n        return ref.masked_syrk_ref(vm, rv)\n")
    return text.replace(block, wrapped)


def _once(old: str, new: str):
    def mutate(text: str) -> str:
        assert text.count(old) == 1, old
        return text.replace(old, new)
    return mutate


MUTANTS = {
    "ordered-sum": ("src/repro_torch/core/gibbs.py", _once(
        'return torch.segment_reduce(rows, "sum", offsets=offsets, axis=axis, unsafe=True)',
        "return rows.new_zeros(rows.shape).index_add_(axis, offsets.long(), rows)")),
    "rng-global": ("src/repro_torch/core/hyper.py", _once(
        "normal = torch.randn((k, k), generator=generator, dtype=dtype, device=device)",
        "normal = torch.randn((k, k), dtype=dtype, device=device)")),
    "tf32": ("src/repro_torch/device.py", _once(
        "torch.backends.cuda.matmul.allow_tf32 = False",
        "torch.backends.cuda.matmul.allow_tf32 = True")),
    "cuda-float-atomic": ("src/repro_torch/csrc/gather_syrk_seg.cu", _once(
        "prec[o * K * K + e] = (float)tot;", "atomicAdd(&prec[o * K * K + e], (float)tot);")),
    "cuda-launch-guard": (OPS, lambda text: _dedent_block(
        text.replace("    with _on_card(v):\n", "", 1), "        err = lib.gather_syrk_seg_launch(",
        8)),
    "cuda-launch-check": (OPS, _once('    build.check("gather_syrk_seg", err)\n', "")),
    # the ring receives from where it sends
    "ppermute-perm": ("src/repro_torch/core/exchange.py", _once(
        "self.dst, self.src = (r + self.shift) % n, (r - self.shift) % n",
        "self.dst, self.src = (r + self.shift) % n, (r + self.shift) % n")),
    # only the first rank compares the cards
    "collective-branch": ("src/repro_torch/core/exchange.py", _once(
        "        dist.all_gather_object(cards,",
        "        if self.rank == 0:\n            dist.all_gather_object(cards,")),
    "cuda-fallback": (OPS, _swallowing),
}


@pytest.mark.parametrize("rule", sorted(MUTANTS))
def test_live_file_is_clean_and_its_mutant_is_flagged_by_one_rule(rule):
    rel, mutate = MUTANTS[rule]
    text = (ROOT / rel).read_text()
    assert analyze_source(text, filename=rel) == []
    mutant = mutate(text)
    assert mutant != text
    if rel.endswith(".py"):
        ast.parse(mutant)
    found = analyze_source(mutant, filename=rel)
    assert found and set(rules_of(found)) == {rule}, found


# ---------------------------------------------------------------------------
# CLI, baseline
# ---------------------------------------------------------------------------
def test_cli_exit_codes(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert main([str(clean), "--root", str(tmp_path)]) == 0
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert [line.split()[0] for line in out.splitlines()] == list(ALL_RULES)
    assert main([str(clean), "--rules", "no-such-rule"]) == 2
    assert main([str(tmp_path / "missing.py")]) == 2
    assert main([str(clean), "--ptxas", f"a.cu={tmp_path / 'no.log'}"]) == 2
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    assert main([str(bad), "--root", str(tmp_path)]) == 2
    cu = tmp_path / "k.cu"
    cu.write_text(ATOMIC)
    assert main([str(cu), "--root", str(tmp_path)]) == 1


def test_cli_json_report_and_out_file(tmp_path, capsys):
    target = tmp_path / "mod.py"
    target.write_text(GUARDED)
    report = tmp_path / "lint-report.json"
    rc = main([str(target), "--root", str(tmp_path), "--format", "json", "--out",
               str(report)])
    assert rc == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload == json.loads(report.read_text())
    assert payload["summary"] == {"guarded-field": 1}
    (finding,) = payload["findings"]
    assert (finding["path"], finding["rule"], finding["scope"]) == (
        "mod.py", "guarded-field", "Coord.peek")


def test_baseline_round_trip(tmp_path):
    target = tmp_path / "mod.py"
    target.write_text(GUARDED)
    base_file = tmp_path / "base.json"
    args = [str(target), "--root", str(tmp_path), "--baseline", str(base_file)]
    assert main(args) == 1                      # finding, no baseline yet
    assert main([*args, "--write-baseline"]) == 0
    assert main(args) == 0                      # grandfathered
    data = json.loads(base_file.read_text())
    assert data["version"] == baseline_mod.BASELINE_VERSION
    (key,) = data["findings"]
    assert key.startswith("mod.py::guarded-field::Coord.peek::")
    # a reason written beside the entry survives a rewrite of the file
    data["reasons"] = {key: "snapshot read"}
    base_file.write_text(json.dumps(data))
    assert main([*args, "--write-baseline"]) == 0
    assert baseline_mod.reasons(base_file) == {key: "snapshot read"}
    # keys survive line churn but not edits to the flagged line
    target.write_text("# a new leading comment\n" + GUARDED)
    assert main(args) == 0
    target.write_text(GUARDED.replace("return self.epoch", "return self.epoch + 1"))
    assert main(args) == 1


def test_cli_spill_from_a_ptxas_log_and_its_baseline(tmp_path, capsys):
    log = tmp_path / "flash.log"
    log.write_text(PTXAS_SPILL)
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    base_file = tmp_path / "base.json"
    args = [str(clean), "--root", str(tmp_path), "--baseline", str(base_file),
            "--ptxas", f"{FLASH_CU}={log}", "--format", "json"]
    assert main(args) == 1
    (finding,) = json.loads(capsys.readouterr().out)["findings"]
    assert (finding["path"], finding["rule"]) == (FLASH_CU, "cuda-spill")
    assert main([*args, "--write-baseline"]) == 0
    (key,) = json.loads(base_file.read_text())["findings"]
    assert key.startswith(f"{FLASH_CU}::cuda-spill::") and key.endswith("::")
    assert main(args) == 0
    log.write_text(PTXAS_CLEAN)
    assert main(args) == 0 and main([*args, "--rules", "cuda-spill"]) == 0


def test_spill_entries_are_kept_and_not_stale_without_ptxas_logs(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    base_file = tmp_path / "base.json"
    key = f"{FLASH_CU}::cuda-spill::entry::"
    base_file.write_text(json.dumps({"version": 1, "findings": {key: 1},
                                     "reasons": {key: "recorded"}}))
    args = [str(clean), "--root", str(tmp_path), "--baseline", str(base_file)]
    assert main([*args, "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["baseline"] == {"suppressed": 0, "stale": []}
    assert main([*args, "--write-baseline"]) == 0
    assert json.loads(base_file.read_text())["findings"] == {key: 1}
    assert baseline_mod.reasons(base_file) == {key: "recorded"}


def test_cli_changed_only_outside_git_is_usage_error(tmp_path, monkeypatch):
    target = tmp_path / "mod.py"
    target.write_text("x = 1\n")
    monkeypatch.setenv("GIT_CEILING_DIRECTORIES", str(tmp_path.parent))
    monkeypatch.setenv("GIT_DIR", str(tmp_path / "no-such-gitdir"))
    assert main([str(target), "--root", str(tmp_path), "--changed-only"]) == 2


# ---------------------------------------------------------------------------
# stdlib only, and the live tree
# ---------------------------------------------------------------------------
def test_analyzer_imports_only_the_standard_library():
    files = sorted((PORT / "analysis").glob("*.py"))
    assert {f.name for f in files} >= {"__init__.py", "__main__.py", "cli.py", "common.py",
                                       "baseline.py", "locks.py", "syncs.py", "rng.py",
                                       "sums.py", "tf32.py", "loops.py", "cuda.py"}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, f
                names = [node.module]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root in sys.stdlib_module_names or name.startswith(
                    "repro_torch.analysis"), (f.name, name)
    package_init = ast.parse((PORT / "__init__.py").read_text())
    assert not any(isinstance(n, (ast.Import, ast.ImportFrom)) for n in ast.walk(package_init))


#: runs the lint's CLI in an interpreter where importing torch, numpy or jax fails
BLOCKED = """
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "numpy", "jax", "jaxlib", "repro"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Block())
sys.argv = ["repro_torch.analysis", *sys.argv[1:]]
runpy.run_module("repro_torch.analysis", run_name="__main__", alter_sys=True)
"""


def _blocked(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", BLOCKED, *args], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)


def test_list_rules_runs_where_torch_numpy_and_jax_cannot_be_imported():
    out = _blocked("--list-rules")
    assert out.returncode == 0, out.stderr
    assert [line.split()[0] for line in out.stdout.splitlines()] == list(ALL_RULES)


def test_analyzer_clean_on_live_tree_against_the_checked_in_baseline():
    """`python -m repro_torch.analysis` (src/repro_torch, tests/test_torch_*.py
    and chip_smoke.py) exits 0 against the checked-in baseline, which holds
    only cuda-spill entries, each with its reason (they apply only where
    ptxas output is read): every source finding is repaired or suppressed
    on its line with its reason. Run where torch, numpy and jax cannot be
    imported."""
    base = json.loads((ROOT / baseline_mod.DEFAULT_BASELINE).read_text())
    assert all(baseline_mod.SPILL_KEY in k for k in base["findings"])
    assert set(base["reasons"]) == set(base["findings"])
    assert all(len(r) > 40 for r in base["reasons"].values())
    out = _blocked("--root", str(ROOT), "--format", "json")
    assert out.returncode == 0, out.stdout + out.stderr
    payload = json.loads(out.stdout)
    assert payload["findings"] == [] and payload["parse_errors"] == []
    assert payload["baseline"] == {"suppressed": 0, "stale": []}
    assert payload["files_analyzed"] > 100
