"""Atomic, async, keep-last-N checkpoint writer (the part SampleStore needs).

The on-disk layout is the reference's (`repro.checkpoint.store`), so either
package reads what the other wrote:

    <root>/step_<N>/manifest.json + leaf_<i>.npy

A flat dict is written in sorted key order with the paths "['key']", which
is how the reference flattens the same dict. Atomicity: the step is written
into step_<N>.tmp, fsync'd, then renamed; a reader never sees a partial
step and a crash mid-save leaves the previous steps intact. Async mode
hands the host-side write to a worker thread.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch


def _to_host(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


class CheckpointStore:
    def __init__(self, root: str | Path, *, keep: int = 3, use_async: bool = False):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.use_async = use_async
        self._pool = (
            concurrent.futures.ThreadPoolExecutor(max_workers=1) if use_async else None
        )
        self._pending: concurrent.futures.Future | None = None
        self._lock = threading.Lock()

    def save(self, step: int, arrays: dict) -> None:
        """Write one step of a flat {name: array} dict."""
        # the device -> host copy happens here, synchronously (a consistent
        # snapshot); only the file writes go to the worker
        host_leaves = [(f"['{k}']", _to_host(arrays[k])) for k in sorted(arrays)]
        if self.use_async:
            self.wait()
            self._pending = self._pool.submit(self._write, step, host_leaves)
        else:
            self._write(step, host_leaves)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, host_leaves) -> None:
        with self._lock:
            final = self.root / f"step_{step:010d}"
            tmp = self.root / f"step_{step:010d}.tmp"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "leaves": []}
            for i, (path, arr) in enumerate(host_leaves):
                fn = f"leaf_{i:05d}.npy"
                np.save(tmp / fn, arr)
                manifest["leaves"].append(
                    {"path": path, "file": fn,
                     "shape": list(arr.shape), "dtype": str(arr.dtype)}
                )
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
            fd = os.open(tmp, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.root / f"step_{s:010d}", ignore_errors=True)

    def all_steps(self) -> list[int]:
        out = []
        for d in self.root.glob("step_*"):
            if d.suffix == ".tmp" or not (d / "manifest.json").exists():
                continue
            out.append(int(d.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_arrays(self, step: int | None = None) -> dict[str, np.ndarray]:
        """One step as {path: host array}, in manifest order."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.root}")
        d = self.root / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        return {meta["path"]: np.load(d / meta["file"])
                for meta in manifest["leaves"]}

    def restore(self, like: dict, step: int | None = None, placements: dict | None = None,
                mesh=None) -> dict:
        """Step `step` (the latest when None) as {name: tensor} for every
        name of `like` ({name: tensor}, whose shapes and dtypes the arrays
        must have; the store's "['name']" paths match their names; bf16
        from int16 bit patterns): on each template's device, or, where
        `placements` ({name: DTensor placements} on `mesh`) names it, as a
        DTensor of which this rank holds its slice (`shard_from_host`)."""
        arrays = {k[2:-2] if k.startswith("['") else k: v
                  for k, v in self.read_arrays(step).items()}
        out = {}
        for name, t in like.items():
            if name not in arrays:
                raise ValueError(f"checkpoint lacks {name}")
            try:
                src = host_tensor(arrays[name], t)
            except ValueError as err:
                raise ValueError(f"{name}: {err}") from None
            if placements is not None and name in placements:
                out[name] = shard_from_host(src, mesh, placements[name])
            else:
                out[name] = src.to(t.device)
        return out


def host_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A stored array as a host tensor of `like`'s dtype (bf16 from its
    int16 bit patterns), its shape checked against like's."""
    src = torch.from_numpy(np.array(arr))
    if like.dtype == torch.bfloat16 and src.dtype == torch.int16:
        src = src.view(torch.bfloat16)
    if tuple(src.shape) != tuple(like.shape) or src.dtype != like.dtype:
        raise ValueError(f"checkpoint has {tuple(src.shape)} {src.dtype}, the state "
                         f"{tuple(like.shape)} {like.dtype}")
    return src


def shard_from_host(src: torch.Tensor, mesh, pl: tuple) -> torch.Tensor:
    """This rank's shard of a host tensor, on the mesh's device, as a DTensor
    of placements `pl`: sliced on the host, then copied (no collective)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(src.shape, mesh, pl)
    local = src[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    return DTensor.from_local(local.contiguous().to(dev), mesh, pl, run_check=False,
                              shape=src.shape, stride=src.contiguous().stride())
