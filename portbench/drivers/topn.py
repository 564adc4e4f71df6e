"""Drives the port's batch top-N: `TopNRecommender(ensemble).recommend(ids,
topk)` in a closed loop, one batch issued as the last one returns.

Set-up makes the S retained draws from the seed (`portbench/data/
draws.py`), builds the ensemble and the recommender from them (the
scoring matrices are the program's set-up), and warms up both batch
shapes a pass uses. A pass is a seeded permutation of every user, cut
into batches of `traffic["batch"]`; the window repeats passes. Every list
of the window's first pass is kept, and every batch of a later pass with
probability `traffic["sample_share"]`, drawn from the seed; once the
window has closed the reference scores those users from the raw draws and
judges each list.

The unit of work is a user given a list (`users`); `batches` counts calls.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.data.draws import draws
from portbench.data.seeds import host_rng
from portbench.reference import topn as ref
from portbench.reference.arith import Arith, no_tf32


class Driver:
    unit = "users"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans):
        self.device = torch.device(device)
        self.topk = int(traffic["topk"])
        n_draws = int(cfg["serve"]["draws"])
        with spans("inputs"):
            self.draws = draws(cfg, n_draws, seed, self.device)
        s, m, k = self.draws.u.shape
        self.sizes = {"m": m, "n": self.draws.v.shape[1], "k": k, "draws": s, "topk": self.topk,
                      "batch": int(traffic["batch"])}
        self.program = {}
        with spans("program"):
            self.build()
        order = host_rng(seed, "users").permutation(m).astype(np.int32)
        b = self.sizes["batch"]
        self.batches = [order[i:i + b] for i in range(0, m, b)]
        self.sample = host_rng(seed, "sample")
        self.share = float(traffic["sample_share"])
        self.counts = {"users": 0, "batches": 0}
        self.failed = 0
        self.kept: list = []
        self.i = 0
        # both shapes of a pass: a whole batch and the short last one
        with spans("warmup"):
            for ids in {len(x): x for x in self.batches}.values():
                self.rec.recommend(ids, self.topk)

    def build(self) -> None:
        """The program's set-up: the ensemble of the draws, on the device,
        and the recommender over it."""
        from repro_torch.serve import PosteriorEnsemble, TopNRecommender

        s, _, k = self.draws.u.shape
        zeros, eye = torch.zeros((s, k)), torch.eye(k).expand(s, k, k)
        ens = PosteriorEnsemble.from_arrays(
            self.draws.u, self.draws.v, hyper_u_mu=zeros, hyper_u_lam=eye,
            hyper_v_mu=zeros, hyper_v_lam=eye, global_mean=self.draws.global_mean,
            alpha=self.draws.alpha, steps=list(range(s)), device=self.device)
        self.rec = TopNRecommender(ens, device=self.device)

    def step(self) -> None:
        ids = self.batches[self.i % len(self.batches)]
        vals, items = self.rec.recommend(ids, self.topk)
        if self.i < len(self.batches) or self.sample.random() < self.share:
            self.kept.append((ids, vals, items))
        self.i += 1
        self.counts["users"] += len(ids)
        self.counts["batches"] += 1

    def release(self) -> None:
        self.rec = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def rerun(self) -> list:
        """The kept batches' users served again by a program built anew."""
        self.build()
        return [(ids, *self.rec.recommend(ids, self.topk)) for ids, _, _ in self.kept]

    def control(self, precision: str) -> list:
        """The kept batches' lists as served from the reference in
        `precision`: a control put in the program's place."""
        ar = Arith(precision)
        out = []
        with no_tf32():
            for ids, _, _ in self.kept:
                users = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
                vals, items = ref.topk(self.draws.u, self.draws.v, users,
                                       self.draws.global_mean, self.topk, ar)
                out.append((ids, vals, items))
        return out

    def reference(self) -> None:
        """Nothing to precompute: `judge` scores each batch afresh."""
        return None

    def judge(self, served: list, precomputed=None) -> dict:
        """score_err and rank_gap, the widest over the served lists, each
        judged against the float64 reference's scores (`precomputed`, what
        `reference()` gives, is None: each batch is scored afresh)."""
        ar = Arith("float64")
        worst = {"score_err": 0.0, "rank_gap": 0.0}
        self.failed = 0
        with no_tf32():
            for ids, vals, items in served:
                users = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
                want = ref.scores(self.draws.u, self.draws.v, users,
                                  self.draws.global_mean, ar)
                err, gap, bad = ref.judge(torch.as_tensor(vals), torch.as_tensor(items),
                                          want, self.topk)
                worst["score_err"] = max(worst["score_err"], err)
                worst["rank_gap"] = max(worst["rank_gap"], gap)
                self.failed += bad
        return worst

    def outputs(self) -> list:
        """What the check judges: the kept batches' lists."""
        return self.kept

    def check(self) -> dict:
        return self.judge(self.outputs())
