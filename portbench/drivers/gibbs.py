"""Drives the port's Gibbs sampler: `GibbsSampler.sweep(state, noise)` in a
closed loop, each sweep issued as the last one is enqueued, on the noise
the sampler draws itself (`draw_noise()`, from its generator, seeded from
the run seed), as a training run does.

Set-up makes the ratings, the initial factors and the noise of the first
`traffic["checked_sweeps"]` sweeps from the seed (`portbench/data`),
builds the sampler from the ratings (its plans and their device copies
are the program's set-up, timed as the span `sampler.build`), and drives
the chain through those sweeps by the window's own call, keeping what
each produced: the first `burn_in` sweeps, then at least one that adds to
the posterior-predictive sum, as every sweep of the window does. One more
sweep, made as the window makes them, warms up the sampler's noise draw.
The window holds references to the input state, the noise and the output
of its last sweep; nothing is copied until it has closed.

The check runs the reference's chain from the same start on the same
noise and compares every factor row, both sides' hyperparameters and the
prediction sum after each of the checked sweeps; then it runs one
reference sweep from the window's last input state on that sweep's noise
and compares what the sweep produced. That start is the program's own
state: the reference follows it one sweep, and the chain's start is
checked by the first sweeps. The noise is an input to both sides and is
not judged.

The unit of work is a sweep, `updates` counts the factor rows it redraws
(users + items).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.data import noise as bnoise
from portbench.data.ratings import ratings
from portbench.data.seeds import generator, stream_seed
from portbench.reference import bpmf
from portbench.reference.arith import Arith, no_tf32
from portbench.reference.compare import rel_err

#: what the check compares after each checked sweep
QUANTITIES = ("u", "v", "mu_u", "lam_u", "mu_v", "lam_v", "pred_sum")


def _host(r):
    from repro_torch.data.sparse import SparseRatings

    return SparseRatings(rows=r.rows.cpu().numpy().astype(np.int32),
                         cols=r.cols.cpu().numpy().astype(np.int32),
                         vals=r.vals.cpu().numpy().astype(np.float32), shape=r.shape)


def program_noise(nz: bnoise.SweepInputs):
    """The benchmark's noise as the port's SweepNoise."""
    from repro_torch.core.gibbs import SweepNoise
    from repro_torch.core.hyper import WishartNoise

    def wishart(s):
        return WishartNoise(chi2=s.chi2, normal=s.normal, z=s.z_mu)

    return SweepNoise(hyper_v=wishart(nz.items), z_v=nz.items.z,
                      hyper_u=wishart(nz.users), z_u=nz.users.z)


def snapshot(st) -> dict:
    """What a sweep produced, copied to the host."""
    return {"u": st.u.cpu(), "v": st.v.cpu(), "mu_u": st.hyper_u.mu.cpu(),
            "lam_u": st.hyper_u.lam.cpu(), "mu_v": st.hyper_v.mu.cpu(),
            "lam_v": st.hyper_v.lam.cpu(), "pred_sum": st.pred_sum.cpu()}


class Driver:
    unit = "sweeps"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans):
        from repro_torch.core.gibbs import GibbsSampler

        self.cfg = cfg
        self.device = torch.device(device)
        model = cfg["model"]
        self.k = int(model["k"])
        self.alpha = float(model["alpha"])
        self.burn_in = int(model["burn_in"])
        self.nu0 = float(model["prior"]["nu0"])
        with spans("inputs"):
            self.data = ratings(cfg, seed, self.device)
        train, test = self.data.train, self.data.test
        self.m, self.n = train.shape
        self.sizes = {
            "m": self.m, "n": self.n, "k": self.k, "nnz": train.nnz,
            "n_test": test.nnz,
            "users_rated": int((train.degrees(0) > 0).sum()),
            "items_rated": int((train.degrees(1) > 0).sum()),
        }
        train_h, test_h = _host(train), _host(test)
        with spans("sampler.build"):
            self.sampler = GibbsSampler(
                train_h, test_h, k=self.k, alpha=self.alpha, burn_in=self.burn_in,
                widths=model["widths"], engine=model["engine"],
                bf16_gather=bool(model["bf16_gather"]), device=self.device)
        plans = (self.sampler.user_plan_host, self.sampler.item_plan_host)
        self.program = {"plan.nnz": sum(p.nnz for p in plans),
                        "plan.padded": sum(p.padded for p in plans)}
        u0, v0 = bnoise.initial_factors(self.m, self.n, self.k, float(model["init_scale"]),
                                        generator(seed, "init", self.device))
        self.start = (u0, v0)
        self.noise_gen = generator(seed, "noise", self.device)
        self.counts = {"sweeps": 0, "updates": 0}
        self.failed = 0
        # the chain's first sweeps, by the window's own call; the check
        # follows them
        self.checked_noise = [self._noise() for _ in range(int(traffic["checked_sweeps"]))]
        with spans("checked"):
            self.produced = self.rerun()
        self.sampler.generator.manual_seed(stream_seed(seed, "program_noise"))
        self.last = self.window = None
        with spans("warmup"):
            self.step()

    def rerun(self) -> list[dict]:
        """The chain from its start through the checked sweeps, by the
        window's own call; what each sweep produced, on the host."""
        from repro_torch.core.gibbs import BPMFState
        from repro_torch.core.hyper import init_hyper

        u0, v0 = self.start
        hyper = init_hyper(self.k, device=self.device)
        self.state = BPMFState(u=u0.clone(), v=v0.clone(), hyper_u=hyper, hyper_v=hyper,
                               step=0, pred_sum=torch.zeros_like(self.sampler.test_vals),
                               pred_count=0)
        out = []
        for nz in self.checked_noise:
            self._sweep(program_noise(nz))
            out.append(snapshot(self.state))
        return out

    def _noise(self) -> bnoise.SweepInputs:
        return bnoise.sweep_noise(self.m, self.n, self.k, self.nu0, self.noise_gen)

    def _sweep(self, noise) -> None:
        self.state = self.sampler.sweep(self.state, noise)
        self.counts["sweeps"] += 1
        self.counts["updates"] += self.m + self.n

    def step(self) -> None:
        noise = self.sampler.draw_noise()
        start = self.state
        self._sweep(noise)
        self.last = (start, noise, self.state)

    def _window_record(self) -> dict | None:
        """The window's last sweep, on the host: its input state, its noise
        (as the reference takes it) and what it produced."""
        if self.window is None and self.last is not None:
            start, noise, out = self.last
            self.window = {
                "start": {"u": start.u.cpu(), "v": start.v.cpu(), "step": start.step,
                          "pred_sum": start.pred_sum.cpu(), "pred_count": start.pred_count},
                "noise": tuple(bpmf.Noise(h.chi2.cpu(), h.normal.cpu(), h.z.cpu(), z.cpu())
                               for h, z in ((noise.hyper_v, noise.z_v),
                                            (noise.hyper_u, noise.z_u))),
                "out": snapshot(out)}
            self.last = None
        return self.window

    def outputs(self) -> list[dict]:
        """What the check judges: each checked sweep's state, then the
        window's last."""
        w = self._window_record()
        return self.produced + ([w["out"]] if w else [])

    def release(self) -> None:
        """Free the program: the sampler, its plans and its state."""
        self._window_record()
        self.sampler = self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_chain(self, precision: str) -> list[dict]:
        """The reference's states after each checked sweep, then after its
        sweep from the window's last input state, on the host."""
        ar = Arith(precision)
        train, test = self.data.train, self.data.test
        gm = float(train.vals.double().mean())
        centred = train.vals.double() - gm
        items = bpmf.side(train.cols, train.rows, centred, self.n)
        users = bpmf.side(train.rows, train.cols, centred, self.m)
        prior = bpmf.Prior(beta0=float(self.cfg["model"]["prior"]["beta0"]), nu0=self.nu0)
        u0, v0 = self.start
        eye = torch.eye(self.k, dtype=ar.dtype, device=self.device)
        zero = torch.zeros(self.k, dtype=ar.dtype, device=self.device)
        st = bpmf.State(ar.cast(u0), ar.cast(v0), zero, eye, zero, eye, 0,
                        torch.zeros(test.nnz, dtype=ar.dtype, device=self.device), 0)
        # (a start, or None to go on from the last state; the sweep's noise)
        sweeps = [(None, tuple(bpmf.Noise(*s) for s in (nz.items, nz.users)))
                  for nz in self.checked_noise]
        w = self._window_record()
        if w:
            s0 = w["start"]

            def dev(t):
                return ar.cast(t.to(self.device))

            sweeps.append((bpmf.State(dev(s0["u"]), dev(s0["v"]), zero, eye, zero, eye,
                                      s0["step"], dev(s0["pred_sum"]), s0["pred_count"]),
                           tuple(bpmf.Noise(*(t.to(self.device) for t in n))
                                 for n in w["noise"])))
        out = []
        with no_tf32():
            for start, noise in sweeps:
                st = bpmf.sweep(st if start is None else start, items, users, test.rows,
                                test.cols, noise, prior, self.alpha, self.burn_in, gm, ar)
                out.append({"u": st.u.cpu(), "v": st.v.cpu(), "mu_u": st.mu_u.cpu(),
                            "lam_u": st.lam_u.cpu(), "mu_v": st.mu_v.cpu(),
                            "lam_v": st.lam_v.cpu(), "pred_sum": st.pred_sum.cpu()})
        return out

    @staticmethod
    def judge(produced: list[dict], ref: list[dict]) -> dict:
        """The widest relative gap of each quantity over the sweeps both
        lists hold."""
        return {q: max(rel_err(p[q], r[q]) for p, r in zip(produced, ref))
                for q in QUANTITIES}

    def control(self, precision: str) -> list[dict]:
        """The reference in `precision`, put in the program's place."""
        return self.reference_chain(precision)

    def reference(self) -> list[dict]:
        return self.reference_chain("float64")

    def check(self) -> dict:
        return self.judge(self.outputs(), self.reference())
