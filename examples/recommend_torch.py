"""Train -> checkpoint -> serve on the PyTorch port: BPMF top-10
recommendations (`examples/recommend.py` on `repro_torch`).

    PYTHONPATH=src python examples/recommend_torch.py                 # the card
    PYTHONPATH=src python examples/recommend_torch.py --device cpu    # the plain path

Trains a small MovieLens-shaped BPMF model at k = 16, retains post-burn-in
Gibbs draws through the SampleStore, loads them back as a
PosteriorEnsemble and serves top-10 recommendations (the top-N kernel on
the card) for a batch of trained users, with each score's predictive std,
and for a cold-start user folded in from ratings alone.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.checkpoint import SampleStore
from repro_torch.core import GibbsSampler
from repro_torch.data import movielens_like, train_test_split
from repro_torch.data.sparse import SparseRatings
from repro_torch.serve import FoldInPlanCache, PosteriorEnsemble, TopNRecommender, fold_in

TOPK = 10


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--scale", type=float, default=0.003, help="movielens_like's scale")
    ap.add_argument("--sweeps", type=int, default=18)
    args = ap.parse_args(argv)

    ratings, u_true, v_true = movielens_like(scale=args.scale, seed=0)
    train, test = train_test_split(ratings, 0.1, seed=1)
    print(f"dataset {train.shape[0]} x {train.shape[1]}, {train.nnz} ratings")

    # train, retaining post-burn-in draws through the checkpoint store
    sample_dir = tempfile.mkdtemp(prefix="bpmf_samples_")
    store = SampleStore(sample_dir, keep=8)
    burn_in = min(8, args.sweeps - 1)
    sampler = GibbsSampler(train, test, k=16, alpha=4.0, burn_in=burn_in,
                           widths=(8, 32, 128), device=args.device)
    state = sampler.run(args.sweeps, seed=0, store=store)
    print(f"test rmse {sampler.rmse(state):.4f}; "
          f"retained {len(store.steps())} samples -> {sample_dir}")

    # serve from the retained draws alone (no trainer state)
    ens = PosteriorEnsemble.load(sample_dir, device=args.device)
    rec = TopNRecommender(ens, device=args.device)
    users = np.asarray([0, 1, 2, 3], np.int32)
    vals, idx = rec.recommend(users, TOPK, seen=train)
    for r, u in enumerate(users):
        _, var = ens.score(np.full(TOPK, u, np.int32), np.maximum(idx[r], 0))
        std = np.sqrt(var.cpu().numpy())
        top = ", ".join(f"{i}({v:.2f}±{s:.2f})"
                        for i, v, s in zip(idx[r][:5], vals[r], std))
        print(f"user {u:4d} top-{TOPK}: {top}, ...")

    # cold start: a new user folded in from ratings alone, against every
    # retained draw in one batched solve
    rng = np.random.default_rng(7)
    n_rated = min(30, train.shape[1])
    rated = rng.choice(train.shape[1], n_rated, replace=False).astype(np.int32)
    u_new = rng.normal(0.0, 1.0 / np.sqrt(u_true.shape[1]), u_true.shape[1])
    r_new = (v_true[rated] @ u_new + rng.normal(0, 0.3, n_rated)).astype(np.float32)
    cold = SparseRatings(rows=np.zeros(n_rated, np.int32), cols=rated, vals=r_new,
                         shape=(1, train.shape[1]))
    cache = FoldInPlanCache()
    u_draws = fold_in(None, cold, ens, sample=False, plan_cache=cache)
    cvals, cidx = rec.recommend_factors(u_draws, TOPK, exclude=[rated])
    print(f"cold-start user ({n_rated} ratings) top-{TOPK}: "
          + ", ".join(f"{i}({v:.2f})" for i, v in zip(cidx[0], cvals[0])))
    # a user with fewer than TOPK unseen items gets index -1 in the tail
    assert np.isfinite(vals[idx >= 0]).all() and np.isfinite(cvals[cidx >= 0]).all()
    return vals, cvals


if __name__ == "__main__":
    main()
