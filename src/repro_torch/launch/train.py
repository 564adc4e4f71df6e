"""Training launcher of the port, BPMF mode (`repro/launch/train.py`'s
`--bpmf`): train on a synthetic MovieLens-shaped matrix and retain the
post-burn-in draws in a SampleStore, or, with --co-serve, train while
serving them live through launch/serve.py::run_train_and_serve:

    PYTHONPATH=src python -m repro_torch.launch.train --bpmf --sweeps 40
    PYTHONPATH=src python -m repro_torch.launch.train --bpmf --co-serve

Runs on the card ("--device cpu" for the plain path). LM training stays a
library, as in the reference; the distributed trainers and SGLD are not
ported yet (ROADMAP.md, queue 1 items 10-11).
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.core.gibbs import ENGINES


def bpmf_train_main(args) -> None:
    if args.co_serve:
        from repro_torch.launch.serve import run_train_and_serve

        run_train_and_serve(scale=args.scale, sweeps=args.sweeps, k=args.k,
                            burn_in=args.burn_in, window=args.keep,
                            samples=args.samples, seed=args.seed,
                            engine=args.engine, device=args.device)
        return

    from repro_torch.checkpoint import SampleStore
    from repro_torch.core import GibbsSampler
    from repro_torch.launch.serve import _demo_data

    train, test = _demo_data(args.scale, args.seed)
    widths = "balanced" if args.plan == "balanced" else (8, 32, 128)
    sampler = GibbsSampler(train, test, k=args.k, alpha=4.0, burn_in=args.burn_in,
                           widths=widths, engine=args.engine, device=args.device)
    root = args.samples or tempfile.mkdtemp(prefix="bpmf_samples_")
    print(f"training {train.shape[0]} x {train.shape[1]} ({train.nnz} ratings), "
          f"k={args.k}, {args.sweeps} sweeps (burn-in {args.burn_in}), "
          f"engine={args.engine}, device={sampler.device} -> {root}")
    store = SampleStore(root, keep=args.keep)
    state = sampler.run(args.sweeps, seed=args.seed, store=store, thin=args.thin)
    print(f"test rmse {sampler.rmse(state):.4f}; retained {len(store.steps())} "
          f"draws; serve them with: python -m repro_torch.launch.serve --bpmf "
          f"--samples {root}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bpmf", action="store_true",
                    help="train BPMF (the only CLI mode; LM training is a library)")
    ap.add_argument("--samples", default=None,
                    help="SampleStore directory for retained draws "
                         "(default: a fresh temporary directory)")
    ap.add_argument("--sweeps", type=int, default=40)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--burn-in", type=int, default=6)
    ap.add_argument("--keep", type=int, default=4,
                    help="retained-draw window (store keep / channel window)")
    ap.add_argument("--scale", type=float, default=0.01,
                    help="movielens_like dataset scale")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="fused", choices=list(ENGINES),
                    help="Gibbs sweep engine")
    ap.add_argument("--thin", type=int, default=1,
                    help="retain every thin-th post-burn-in draw")
    ap.add_argument("--plan", default="balanced", choices=["balanced", "pow2"],
                    help="bucket planner: 'balanced' fits the widths to the "
                         "degree profile, 'pow2' is the fixed ladder")
    ap.add_argument("--co-serve", action="store_true",
                    help="serve live recommendations from this process while "
                         "training, through the publication channel")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain path")
    args = ap.parse_args(argv)
    if not args.bpmf:
        raise SystemExit("only --bpmf has a CLI; LM training is a library")
    bpmf_train_main(args)


if __name__ == "__main__":
    main()
