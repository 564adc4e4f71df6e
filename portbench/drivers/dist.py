"""Drives the port's distributed sampler: `DistributedBPMF.sweep(state,
noise)` in a closed loop over P shards, one a card, in the exchange mode
the configuration's `layout` names, on the noise the sampler draws itself
(`draw_noise()`, from its generator, seeded from the run seed).

Set-up makes the ratings, the initial factors and the noise of the first
`traffic["checked_sweeps"]` sweeps from the seed with the generators of
`drivers/gibbs.py` (`portbench/data`), builds the sampler from the
ratings (its partitions, grid plans and their copies to the cards are the
span `sampler.build`), places the initial factors into the shards by the
sampler's own partitions (`u_part`, `v_part`: padding slots 0), and drives
the chain through the checked sweeps by the window's own call, keeping
what each produced. One more sweep, made as the window makes them, warms
up the sampler's noise draw. The window holds references to the input
state, the noise and the output of its last sweep; nothing is copied
until it has closed.

The check runs the plain asynchronous sweep (`reference/bpmf_async.py`)
from the same start on the same noise and compares U, the fresh V and
both sides' hyperparameters, in global id order (the program's
`gather_factors(coupled=False)`), after each checked sweep; then one
reference sweep from the window's last input state on that sweep's noise.
The noise is an input to both sides and is not judged.

The unit of work is a sweep; `updates` counts the factor rows it redraws
(users + items).
"""
from __future__ import annotations

import torch

from portbench.data import noise as bnoise
from portbench.data.ratings import ratings
from portbench.data.seeds import generator, stream_seed
from portbench.drivers.gibbs import _host, program_noise
from portbench.reference import bpmf, bpmf_async
from portbench.reference.arith import Arith
from portbench.reference.compare import rel_err

#: what the check compares after each checked sweep
QUANTITIES = ("u", "v", "mu_u", "lam_u", "mu_v", "lam_v")


class Driver:
    unit = "sweeps"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans):
        from repro_torch.core.distributed import DistributedBPMF, shard_devices

        self.cfg = cfg
        self.device = torch.device(device)
        model, layout = cfg["model"], cfg["layout"]
        self.k = int(model["k"])
        self.alpha = float(model["alpha"])
        self.nu0 = float(model["prior"]["nu0"])
        with spans("inputs"):
            self.data = ratings(cfg, seed, self.device)
        train = self.data.train
        self.m, self.n = train.shape
        devices = shard_devices(int(layout["shards"]), self.device)
        with spans("sampler.build"):
            self.sampler = DistributedBPMF(
                _host(train), devices=devices, k=self.k, alpha=self.alpha,
                width=model["width"], mode=layout["mode"], engine=model["engine"])
        s = self.sampler
        plans = (s.u_plan, s.v_plan)
        self.sizes = {
            "m": self.m, "n": self.n, "k": self.k, "nnz": train.nnz, "P": s.n_shards,
            "cards": len(set(s.devices)),
            "shard_ratings_u": [int(s.u_plan.mask[p].sum()) for p in range(s.n_shards)],
            "shard_ratings_v": [int(s.v_plan.mask[p].sum()) for p in range(s.n_shards)],
        }
        self.program = {"plan.nnz": sum(p.nnz for p in plans),
                        "plan.padded": sum(p.padded_lanes for p in plans)}
        self.start = bnoise.initial_factors(self.m, self.n, self.k, float(model["init_scale"]),
                                            generator(seed, "init", self.device))
        self.noise_gen = generator(seed, "noise", self.device)
        self.counts = {"sweeps": 0, "updates": 0}
        self.failed = 0
        # the chain's first sweeps, by the window's own call; the check
        # follows them
        self.checked_noise = [
            bnoise.sweep_noise(self.m, self.n, self.k, self.nu0, self.noise_gen)
            for _ in range(int(traffic["checked_sweeps"]))]
        with spans("checked"):
            self.produced = self.rerun()
        s.generator.manual_seed(stream_seed(seed, "program_noise"))
        self.last = self.window = None
        with spans("warmup"):
            self.step()

    def _shards(self, x: torch.Tensor, part) -> tuple[torch.Tensor, ...]:
        """x (entities, K) in global id order as the sampler's shards: shard
        p's slots on its device, a padding slot 0."""
        ids = torch.as_tensor(part.ids, device=x.device).long()
        rows = torch.where((ids >= 0)[..., None], x[ids.clamp(min=0)], 0.0)
        return tuple(rows[p].to(d) for p, d in enumerate(self.sampler.devices))

    def rerun(self) -> list[dict]:
        """The chain from its start through the checked sweeps, by the
        window's own call; what each sweep produced, on the host."""
        from repro_torch.core.distributed import DistState
        from repro_torch.core.hyper import init_hyper

        s = self.sampler
        u0, v0 = self.start
        v = self._shards(v0, s.v_part)
        hyper = init_hyper(self.k, device=s.devices[0])
        self.state = DistState(u=self._shards(u0, s.u_part), v=v, hyper_u=hyper,
                               hyper_v=hyper, step=0,
                               v_eval=v if s.mode == "async" else None)
        out = []
        for nz in self.checked_noise:
            self._sweep(program_noise(nz))
            out.append(self.snapshot(self.state))
        return out

    def snapshot(self, st) -> dict:
        """What a sweep produced, on the host in global id order: U, the
        fresh V (what the next sweep reads) and both hyperparameters."""
        u, v = self.sampler.gather_factors(st, coupled=False)
        return {"u": torch.from_numpy(u), "v": torch.from_numpy(v),
                "mu_u": st.hyper_u.mu.cpu(), "lam_u": st.hyper_u.lam.cpu(),
                "mu_v": st.hyper_v.mu.cpu(), "lam_v": st.hyper_v.lam.cpu()}

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
        """The window's last sweep, on the host: its input factors, its
        noise (as the reference takes it) and what it produced."""
        if self.window is None and self.last is not None:
            start, noise, out = self.last
            u, v = self.sampler.gather_factors(start, coupled=False)
            self.window = {
                "start": {"u": torch.from_numpy(u), "v": torch.from_numpy(v),
                          "step": start.step},
                "noise": tuple(bpmf.Noise(h.chi2.cpu(), h.normal.cpu(), h.z.cpu(), z.cpu())
                               for h, z in ((noise.hyper_v, noise.z_v),
                                            (noise.hyper_u, noise.z_u))),
                "out": self.snapshot(out)}
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
        train = self.data.train
        centred = train.vals.double() - float(train.vals.double().mean())
        items = bpmf.side(train.cols, train.rows, centred, self.n)
        users = bpmf.side(train.rows, train.cols, centred, self.m)
        prior = bpmf.Prior(beta0=float(self.cfg["model"]["prior"]["beta0"]), nu0=self.nu0)
        eye = torch.eye(self.k, dtype=ar.dtype, device=self.device)
        zero = torch.zeros(self.k, dtype=ar.dtype, device=self.device)

        def state(u, v, step):
            return bpmf.State(ar.cast(u.to(self.device)), ar.cast(v.to(self.device)), zero,
                              eye, zero, eye, step, None, 0)

        # (a start, or None to go on from the last state; the sweep's noise)
        sweeps = [(None, tuple(bpmf.Noise(*s) for s in (nz.items, nz.users)))
                  for nz in self.checked_noise]
        w = self._window_record()
        if w:
            s0 = w["start"]
            sweeps.append((state(s0["u"], s0["v"], s0["step"]),
                           tuple(bpmf.Noise(*(t.to(self.device) for t in n))
                                 for n in w["noise"])))
        st, out = state(*self.start, 0), []
        for start, noise in sweeps:
            st = bpmf_async.sweep(st if start is None else start, items, users, noise, prior,
                                  self.alpha, ar)
            out.append({q: getattr(st, q).cpu() for q in QUANTITIES})
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
