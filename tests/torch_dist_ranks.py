"""The ranks of tests/test_torch_dist_ranks.py: four CPU processes on a gloo
process group, the distributed sampler with one item shard a rank.

    python tests/torch_dist_ranks.py DIR

reads DIR/reference.npz (the JAX package's initial state, its replayed
noise of one sweep and of a 3-sweep chain, written by the test's JAX side)
and has rank r write DIR/rank{r}.npz with its shard of:

  - one `DistributedBPMF(mesh=)` sweep in every mode and engine from the
    reference's initial state under its noise: u, v (v_eval in async) and
    both hyperparameters;
  - a 3-sweep ring chain under the chain's noise (each engine) and its RMSE;
  - the fused ring sweep with `RankRing.shift = -1` (the ring planted to
    forward to r - 1);
  - two `DistributedSGLD(mesh=)` steps in every mode from `init(SEED)`,
    under the noise every rank draws from its own generator;
  - the exchange's counts of isend/irecv pairs.

Imports only torch, numpy and repro_torch: the JAX side runs in a process
of its own.
"""
import datetime
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N_RANKS = 4
K, ALPHA, SEED = 16, 11.0, 7
MODES = ("ring", "allgather", "async")
ENGINES = ("einsum", "fused")
SGLD_MINIBATCH = 256
#: a rank left waiting at a collective raises after this long
TIMEOUT_S = 120


def _noise(ref: dict, tag: str):
    from repro_torch.core.gibbs import SweepNoise
    from repro_torch.core.hyper import WishartNoise

    def wishart(side):
        return WishartNoise(*(torch.tensor(ref[f"{tag}/hyper_{side}_{name}"])
                              for name in ("chi2", "normal", "z")))

    return SweepNoise(hyper_v=wishart("v"), z_v=torch.tensor(ref[f"{tag}/z_v"]),
                      hyper_u=wishart("u"), z_u=torch.tensor(ref[f"{tag}/z_u"]))


def _save(res: dict, tag: str, st) -> None:
    res[f"{tag}/u"], res[f"{tag}/v"] = st.u[0].numpy(), st.v[0].numpy()
    for side in ("hyper_u", "hyper_v"):
        h = getattr(st, side)
        res[f"{tag}/{side}_mu"], res[f"{tag}/{side}_lam"] = h.mu.numpy(), h.lam.numpy()
    if st.v_eval is not None:
        res[f"{tag}/v_eval"] = st.v_eval[0].numpy()


def rank_main(rank: int, out: str) -> None:
    torch.set_num_threads(1)
    out = Path(out)
    dist.init_process_group("gloo", init_method=f"file://{out / 'pg'}", rank=rank,
                            world_size=N_RANKS, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    from repro_torch.core import exchange
    from repro_torch.core.distributed import DistributedBPMF, dist_state_from_numpy
    from repro_torch.core.sgld import DistributedSGLD
    from repro_torch.data import synthetic_lowrank, train_test_split
    from repro_torch.launch.mesh import make_item_mesh

    mesh = make_item_mesh(device="cpu")
    ratings, _, _ = synthetic_lowrank(300, 200, k_true=8, nnz=9000, noise=0.3, seed=3)
    train, test = train_test_split(ratings, 0.1, seed=4)
    ref = dict(np.load(out / "reference.npz"))
    init = dist_state_from_numpy(
        u=ref["init/u"], v=ref["init/v"], mesh=mesh,
        hyper_u=(ref["init/hyper_u_mu"], ref["init/hyper_u_lam"]),
        hyper_v=(ref["init/hyper_v_mu"], ref["init/hyper_v_lam"]))
    res: dict = {}
    pairs = {}
    for mode in MODES:
        for engine in ENGINES:
            d = DistributedBPMF(train, test, mesh=mesh, k=K, alpha=ALPHA, width="auto",
                                mode=mode, engine=engine)
            _save(res, f"sweep/{mode}/{engine}", d.sweep(init, _noise(ref, "noise")))
            pairs[mode, engine] = d.exchange.times["pairs"]
            if mode != "ring":
                continue
            st = init
            for i in range(3):
                st = d.sweep(st, _noise(ref, f"chain/{engine}/noise{i}"))
            _save(res, f"chain/{engine}", st)
            res[f"chain/{engine}/rmse"] = np.asarray(d.rmse(st))
            if engine == "fused":
                exchange.RankRing.shift = -1
                try:
                    _save(res, "plant", d.sweep(init, _noise(ref, "noise")))
                finally:
                    exchange.RankRing.shift = 1
    res["pairs"] = np.asarray([pairs[m, e] for m in MODES for e in ENGINES])
    for mode in MODES:
        d = DistributedSGLD(train, test, mesh=mesh, k=K, alpha=ALPHA, width="auto",
                            mode=mode, minibatch=SGLD_MINIBATCH)
        st = d.init(SEED)
        for _ in range(2):
            st = d.sweep(st)
        _save(res, f"sgld/{mode}", st)
    np.savez(out / f"rank{rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    mp.spawn(rank_main, args=(sys.argv[1],), nprocs=N_RANKS)


if __name__ == "__main__":
    main()
