"""Fault-tolerant training loop, a copy of `repro/runtime/trainer.py`.

  - checkpoint/restart: atomic keep-N checkpoints (checkpoint/store.py),
    one at step 0 and one every `ckpt_every` steps; auto-resume from the
    latest when the trainer starts;
  - failure handling: every step is wrapped; a failing step (injected here
    through `fail_at_steps`; in a real run a lost device or a preemption)
    restores the latest checkpoint and replays from it. The data pipeline
    is seekable (`data_fn(step)`), so the replayed batches are the same;
  - straggler mitigation: a wall-time watchdog counts steps slower than
    `straggler_factor` x the running median.

The state is a `launch.train.TrainState` (a model, its AdamW state and the
step), updated in place by the train step. A checkpoint holds it as flat
named arrays (`state_arrays`): "params.<name>", "m.<name>", "v.<name>",
"opt_step" and "step"; bf16 tensors are stored as their int16 bit
patterns, so a restore gives the saved bits back. With `state_shardings`
(`launch.train.StateShardings`: a mesh and the state's specs) the state
lives on the mesh as DTensors: a checkpoint gathers each tensor whole
(rank 0 writes), and resume and recovery restore onto the mesh
(`checkpoint/elastic.py::restore_resharded`), whatever mesh or card the
checkpoint was written from. The reference's `Trainer.rescale` has no
code there either, so the port has none (ROADMAP.md, queue 3, "In the
reference").
"""
from __future__ import annotations

import dataclasses
import statistics
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointStore


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str | None = None           # None: a fresh temporary directory
    ckpt_every: int = 50
    keep: int = 3
    use_async_ckpt: bool = True
    max_retries: int = 3
    straggler_factor: float = 3.0
    fail_at_steps: tuple[int, ...] = ()   # failure injection (tests, demos)


def state_tensors(state: Any) -> dict[str, torch.Tensor]:
    """The train state's tensors by checkpoint name (live, not copies)."""
    out = {f"params.{n}": p for n, p in state.params.named_parameters()}
    out.update({f"m.{n}": t for n, t in state.opt.m.items()})
    out.update({f"v.{n}": t for n, t in state.opt.v.items()})
    out["opt_step"] = state.opt.step
    out["step"] = state.step
    return out


def state_arrays(state: Any) -> dict[str, np.ndarray]:
    """The train state as host arrays by name; bf16 as int16 bit patterns.
    A DTensor is gathered whole (a collective: every rank calls this)."""
    from torch.distributed.tensor import DTensor

    out = {}
    for name, t in state_tensors(state).items():
        t = t.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out[name] = t.cpu().numpy()
    return out


def load_state_arrays(state: Any, arrays: dict[str, np.ndarray]) -> None:
    """Copy host arrays (by name, or by the store's "['name']" paths) into
    the state's tensors in place; every tensor must have its array."""
    arrays = {k[2:-2] if k.startswith("['") else k: v for k, v in arrays.items()}
    live = state_tensors(state)
    missing = sorted(set(live) - set(arrays))
    if missing:
        raise ValueError(f"checkpoint lacks {missing[:5]}")
    with torch.no_grad():
        for name, t in live.items():
            src = torch.from_numpy(np.array(arrays[name]))
            if t.dtype == torch.bfloat16:
                src = src.view(torch.bfloat16)
            if tuple(src.shape) != tuple(t.shape) or src.dtype != t.dtype:
                raise ValueError(f"{name}: checkpoint has {tuple(src.shape)} {src.dtype}, "
                                 f"the state {tuple(t.shape)} {t.dtype}")
            t.copy_(src)


class Trainer:
    def __init__(self, train_step: Callable, init_state: Any,
                 data_fn: Callable[[int], dict], cfg: TrainerConfig = TrainerConfig(),
                 state_shardings: Any = None):
        self.train_step = train_step
        self.data_fn = data_fn
        self.cfg = cfg
        root = cfg.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        self.store = CheckpointStore(root, keep=cfg.keep, use_async=cfg.use_async_ckpt)
        self.state_shardings = state_shardings
        self.state = init_state
        latest = self.store.latest_step()
        if latest is not None:
            self._load(latest)
            self.step = latest
            print(f"[trainer] resumed from step {latest}")
        else:
            self.step = 0
        # the state's device (a DTensor's is its mesh's: `init_state` may be
        # a meta-device template of a state restored onto a mesh)
        self.device = self.state.params.embed.device
        self._failed: set[int] = set()
        self._durations: list[float] = []
        self.straggler_events = 0
        self.recoveries = 0

    # ------------------------------------------------------------------
    def _maybe_inject_failure(self, step: int) -> None:
        if step in self.cfg.fail_at_steps and step not in self._failed:
            self._failed.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")

    def _load(self, step: int) -> None:
        """Checkpoint `step` into the state: in place, or onto the mesh of
        `state_shardings`."""
        if self.state_shardings is None:
            load_state_arrays(self.state, self.store.read_arrays(step))
            return
        from repro_torch.checkpoint.elastic import restore_resharded

        sh = self.state_shardings
        self.state = restore_resharded(self.store, self.state, sh.specs, sh.mesh, step)

    def _batch(self, step: int) -> dict:
        """The step's batch on the state's device, or placed on the mesh by
        `state_shardings.batch` (its inputs' specs)."""
        raw = {k: torch.as_tensor(np.asarray(v)) for k, v in self.data_fn(step).items()}
        sh = self.state_shardings
        if sh is None or sh.batch is None:
            return {k: v.to(self.device) for k, v in raw.items()}
        from repro_torch.launch.train import shard_batch

        return shard_batch({k: v.to(self.device) for k, v in raw.items()}, sh.batch, sh.mesh)

    def _save(self) -> None:
        arrays = state_arrays(self.state)
        if not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0:
            self.store.save(self.step, arrays)

    def _recover(self) -> None:
        self.store.wait()
        latest = self.store.latest_step()
        if latest is None:
            raise RuntimeError("failure before the first checkpoint: cannot recover")
        self._load(latest)
        self.step = latest
        self.recoveries += 1
        print(f"[trainer] recovered from checkpoint at step {latest}")

    # ------------------------------------------------------------------
    def run(self, n_steps: int, *, log_every: int = 10) -> dict:
        history = []
        target = self.step + n_steps
        retries = 0
        # a step-0 checkpoint, so the first failure window is covered
        if self.store.latest_step() is None:
            self._save()
        while self.step < target:
            try:
                t0 = time.time()
                self._maybe_inject_failure(self.step)
                batch = self._batch(self.step)
                self.state, metrics = self.train_step(self.state, batch)
                loss = metrics["loss"]
                loss = float(loss.full_tensor() if hasattr(loss, "full_tensor") else loss)
                dt = time.time() - t0
                self._watch_straggler(dt)
                self.step += 1
                retries = 0
                history.append(loss)
                if self.step % log_every == 0:
                    print(f"[trainer] step {self.step} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
                if self.step % self.cfg.ckpt_every == 0:
                    self._save()
            except SimulatedFailure as e:
                print(f"[trainer] {e}")
                retries += 1
                if retries > self.cfg.max_retries:
                    raise
                self._recover()
        self._save()
        self.store.wait()
        return {
            "final_step": self.step,
            "loss_history": history,
            "recoveries": self.recoveries,
            "straggler_events": self.straggler_events,
        }

    def _watch_straggler(self, dt: float) -> None:
        if len(self._durations) >= 5:
            med = statistics.median(self._durations)
            if dt > self.cfg.straggler_factor * med:
                self.straggler_events += 1
                print(f"[trainer] straggler step: {dt:.3f}s vs median {med:.3f}s")
        self._durations.append(dt)
        if len(self._durations) > 100:
            self._durations.pop(0)
