"""Retained posterior samples: the deployable artifact of BPMF training.

BPMF's output is a set of post-burn-in Gibbs draws (U_s, V_s, hyper_s);
serving averages over them. A SampleStore maps each retained draw onto one
CheckpointStore step, so retention inherits the store's atomicity and
keep-last-N pruning. The schema and layout are the reference's
(`repro.checkpoint.samples`): draws written by either package load in the
other.

Readers see retained draws on two paths that share the schema below: the
durable one (a SampleStore directory) and the in-memory one (draws pushed
through a `serve.publish.PublicationChannel` by a co-running trainer;
`as_retained_sample` validates the schema at the publish boundary). A draw
is host arrays on both paths.

Schema per retained draw (flat dict of host arrays):

    u           (M, K) user factors
    v           (N, K) item factors
    hyper_u_mu  (K,)   user hyper mean        hyper_u_lam  (K, K) precision
    hyper_v_mu  (K,)   item hyper mean        hyper_v_lam  (K, K) precision
    global_mean ()     rating offset subtracted before training
    alpha       ()     observation precision
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from repro_torch.checkpoint.store import CheckpointStore

SAMPLE_KEYS = (
    "u", "v", "hyper_u_mu", "hyper_u_lam", "hyper_v_mu", "hyper_v_lam",
    "global_mean", "alpha",
)


@dataclass(frozen=True, eq=False)
class RetainedSample:
    """One post-burn-in Gibbs draw, as host arrays."""

    step: int
    u: np.ndarray
    v: np.ndarray
    hyper_u_mu: np.ndarray
    hyper_u_lam: np.ndarray
    hyper_v_mu: np.ndarray
    hyper_v_lam: np.ndarray
    global_mean: float
    alpha: float


def as_retained_sample(step: int, sample: dict) -> RetainedSample:
    """Validate a flat SAMPLE_KEYS dict into a RetainedSample: the schema
    gate of both publication paths (SampleStore.retain writes the same keys
    to disk; PublicationChannel.publish hands them to readers)."""
    missing = set(SAMPLE_KEYS) - set(sample)
    if missing:
        raise ValueError(f"sample missing keys: {sorted(missing)}")
    return RetainedSample(
        step=int(step),
        u=sample["u"],
        v=sample["v"],
        hyper_u_mu=sample["hyper_u_mu"],
        hyper_u_lam=sample["hyper_u_lam"],
        hyper_v_mu=sample["hyper_v_mu"],
        hyper_v_lam=sample["hyper_v_lam"],
        global_mean=float(sample["global_mean"]),
        alpha=float(sample["alpha"]),
    )


class SampleStore:
    """Keep-last-N store of retained Gibbs draws on top of CheckpointStore.

    Async by default: the host-side write overlaps the next sweep
    (GibbsSampler.run calls wait() before returning).
    """

    def __init__(self, root: str | Path, *, keep: int = 16, use_async: bool = True):
        self.store = CheckpointStore(root, keep=keep, use_async=use_async)

    def retain(self, step: int, sample: dict) -> None:
        """Persist one draw. `sample` must carry SAMPLE_KEYS."""
        missing = set(SAMPLE_KEYS) - set(sample)
        if missing:
            raise ValueError(f"sample missing keys: {sorted(missing)}")
        self.store.save(step, {k: sample[k] for k in SAMPLE_KEYS})

    def wait(self) -> None:
        self.store.wait()

    def steps(self) -> list[int]:
        return self.store.all_steps()

    def load(self, step: int) -> RetainedSample:
        raw = self.store.read_arrays(step)
        flat = {k.strip("[']"): v for k, v in raw.items()}
        return RetainedSample(
            step=step,
            u=flat["u"],
            v=flat["v"],
            hyper_u_mu=flat["hyper_u_mu"],
            hyper_u_lam=flat["hyper_u_lam"],
            hyper_v_mu=flat["hyper_v_mu"],
            hyper_v_lam=flat["hyper_v_lam"],
            global_mean=float(flat["global_mean"]),
            alpha=float(flat["alpha"]),
        )

    def load_all(self, max_samples: int | None = None) -> list[RetainedSample]:
        """The newest `max_samples` retained draws (all if None), oldest
        first. A draw pruned by a co-running trainer between listing and
        loading is skipped."""
        steps = self.steps()
        if max_samples is not None:
            steps = steps[-max_samples:]
        out = []
        for s in steps:
            try:
                out.append(self.load(s))
            except FileNotFoundError:
                continue
        return out

    def epoch(self) -> int | None:
        """Newest retained step, or None when nothing is retained yet."""
        return self.store.latest_step()
