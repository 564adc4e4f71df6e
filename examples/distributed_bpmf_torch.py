"""Distributed BPMF on the PyTorch port: ring (async communication) against
all-gather (sync), P = 4 item shards (`examples/distributed_bpmf.py` on
`repro_torch`).

    PYTHONPATH=src python examples/distributed_bpmf_torch.py                 # the card
    PYTHONPATH=src python examples/distributed_bpmf_torch.py --device cpu    # the plain path

The shards are held in one process on one device (or round-robin over the
visible cards), their exchanges copies between them (core/exchange.py).
Both modes draw the same samples from the same seed, so their RMSEs agree
(paper Sec 5.2).
"""
import argparse
import time

import torch

from repro_torch.core.distributed import DistributedBPMF, shard_devices
from repro_torch.data import chembl_like, train_test_split

SHARDS = 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--scale", type=float, default=0.005, help="chembl_like's scale")
    ap.add_argument("--sweeps", type=int, default=10, help="timed sweeps after one")
    args = ap.parse_args(argv)

    ratings, _, _ = chembl_like(scale=args.scale, seed=0)
    train, test = train_test_split(ratings, 0.1, seed=1)
    devices = shard_devices(SHARDS, device=args.device)
    print(f"{SHARDS} shards on {sorted({str(d) for d in devices})}; "
          f"dataset {train.shape[0]} x {train.shape[1]}, {train.nnz} ratings")

    def sync():
        if devices[0].type == "cuda":
            torch.cuda.synchronize(devices[0])

    results = {}
    for mode in ("ring", "allgather"):
        s = DistributedBPMF(train, test, devices=devices, k=32, alpha=2.0, mode=mode,
                            engine="fused")
        st = s.sweep(s.init(0))
        sync()
        t0 = time.perf_counter()
        for _ in range(args.sweeps):
            st = s.sweep(st)
        sync()
        dt = (time.perf_counter() - t0) / args.sweeps
        results[mode] = (dt, s.rmse(st))
        n_items = train.shape[0] + train.shape[1]
        print(f"{mode:10s} sweep {dt * 1e3:7.1f} ms  ({n_items / dt:,.0f} updates/s)  "
              f"rmse {results[mode][1]:.4f}")
    assert abs(results["ring"][1] - results["allgather"][1]) < 1e-3, \
        "ring and allgather must sample identically (paper Sec 5.2 parity)"
    print("accuracy parity OK: ring == allgather samples")
    return results


if __name__ == "__main__":
    main()
