"""Quickstart of the PyTorch port: BPMF on a synthetic ChEMBL-like dataset,
one device (`examples/quickstart.py` on `repro_torch`).

    PYTHONPATH=src python examples/quickstart_torch.py                 # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu    # the plain path

Builds a power-law rating matrix, runs the bucketed Gibbs sampler and
prints its posterior-mean test RMSE beside the ALS baseline's (paper Secs
2-3, 5.2).
"""
import argparse
import time

import torch

from repro_torch.core import ALS, GibbsSampler
from repro_torch.data import chembl_like, train_test_split


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ratings, _, _ = chembl_like(scale=0.01, seed=0)
    train, test = train_test_split(ratings, test_frac=0.1, seed=1)
    print(f"dataset: {train.shape[0]} x {train.shape[1]}, {train.nnz} train ratings")

    sampler = GibbsSampler(train, test, k=32, alpha=2.0, burn_in=8, device=args.device)
    print("bucket plan:", sampler.user_plan_host.stats())

    t0 = time.perf_counter()
    state = sampler.run(30, seed=0)
    if sampler.device.type == "cuda":
        torch.cuda.synchronize(sampler.device)
    dt = time.perf_counter() - t0
    n_updates = (train.shape[0] + train.shape[1]) * 30
    print(f"\nBPMF posterior-mean RMSE: {sampler.rmse(state):.4f} "
          f"(30 sweeps, {sampler.device})")
    print(f"throughput: {n_updates / dt:,.0f} item updates/sec (paper Fig 4 metric)")

    als = ALS(train, test, k=32, lam_reg=0.1, device=args.device)
    a = als.run(12)
    print(f"ALS baseline RMSE:        {als.rmse(a):.4f} (untuned lambda)")


if __name__ == "__main__":
    main()
