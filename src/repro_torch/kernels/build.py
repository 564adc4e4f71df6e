"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

Each source under `repro_torch/csrc/` is compiled on its own into a shared
library with a plain C interface (`nvcc -gencode arch=compute_90a,
code=sm_90a -shared`), named by a hash of its sources so an edited kernel
is rebuilt, and loaded with ctypes. Nothing is compiled at import: the CPU
tests import every module on machines without nvcc. The libraries go to
`build/repro_torch/` at the root of the checkout (listed in .gitignore).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# kernel name -> (source file, [(C function, argtypes)])
KERNELS = {
    "gather_syrk_seg": ("gather_syrk_seg.cu", [
        ("gather_syrk_seg_launch",
         [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _P]),
        ("gather_syrk_seg_into_launch",
         [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _L, _I, _I,
          _I, _P]),
    ]),
    "masked_syrk": ("masked_syrk.cu", [
        ("masked_syrk_launch", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    ]),
    "chol_solve_sample": ("chol_solve.cu", [
        ("chol_solve_sample_launch", [_P, _P, _P, _P, _I, _I, _I, _P]),
    ]),
    "topn_scores": ("topn.cu", [
        ("topn_scores_launch",
         [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    ]),
    "flash_attention": ("flash_attention.cu", [
        ("flash_attention_launch",
         [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P]),
    ]),
    "flash_attention_bwd": ("flash_attention_bwd.cu", [
        ("flash_attention_bwd_launch",
         [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
          _F, _I, _P]),
    ]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
ptxas_log: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return str(path)


def _target(name: str) -> Path:
    source = CSRC / KERNELS[name][0]
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{out}")
    ptxas_log[name] = out
    os.replace(tmp, target)


def build_all(names=None) -> None:
    """Compile the named kernels (all by default), one nvcc per source, all
    started together, then load them."""
    names = list(KERNELS) if names is None else list(names)
    with _lock:
        started = [(n, _start(n)) for n in names if n not in _libs]
        for n, s in started:
            _finish(n, s)
        for n, _ in started:
            _load_locked(n)


def _load_locked(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in KERNELS[name][1]:
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _libs[name] = lib
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if need be."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib


def check(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
