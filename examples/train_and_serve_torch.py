"""Train while serving on the PyTorch port: a trainer thread publishes
retained draws into a channel that the frontend adopts
(`examples/train_and_serve.py` on `repro_torch`).

    PYTHONPATH=src python examples/train_and_serve_torch.py                 # the card
    PYTHONPATH=src python examples/train_and_serve_torch.py --device cpu    # the plain path

A trainer thread runs the Gibbs chain and publishes every retained
post-burn-in draw into a PublicationChannel (and writes it durably through
the SampleStore); the main thread serves top-10 recommendations the whole
time, the frontend's subscriber adopting each publish as it lands.
"""
import argparse
import tempfile
import threading

import numpy as np

from repro_torch.checkpoint import SampleStore
from repro_torch.core import GibbsSampler
from repro_torch.data import movielens_like, train_test_split
from repro_torch.serve import PublicationChannel, RecommendFrontend

BURN_IN = 6
WINDOW = 4
TOPK = 10
MAX_BATCH = 8


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--scale", type=float, default=0.005, help="movielens_like's scale")
    ap.add_argument("--sweeps", type=int, default=40)
    args = ap.parse_args(argv)

    ratings, _, _ = movielens_like(scale=args.scale, seed=0)
    train, test = train_test_split(ratings, 0.1, seed=1)
    print(f"dataset {train.shape[0]} x {train.shape[1]}, {train.nnz} ratings")

    channel = PublicationChannel(window=WINDOW)
    store = SampleStore(tempfile.mkdtemp(prefix="bpmf_samples_"), keep=WINDOW)
    sampler = GibbsSampler(train, test, k=16, alpha=4.0, burn_in=BURN_IN,
                           widths=(8, 32, 128), device=args.device)
    trainer_error = []

    def train_loop():
        try:
            sampler.run(args.sweeps, seed=0, store=store, publish=channel)
        except BaseException as e:  # noqa: BLE001 (re-raised after the join)
            trainer_error.append(e)
        finally:
            channel.close()         # the end of the stream: serving drains and stops

    trainer = threading.Thread(target=train_loop, name="gibbs-trainer")
    trainer.start()
    try:
        frontend = RecommendFrontend(channel=channel, seen=train, max_batch=MAX_BATCH,
                                     device=args.device)
    except Exception:
        trainer.join()              # the trainer's failure, not the closed channel
        if trainer_error:
            raise trainer_error[0]
        raise
    print(f"serving from epoch {frontend.epoch} while training continues...")

    rng = np.random.default_rng(0)
    served, epochs = 0, []
    while True:
        done = channel.closed and frontend.epoch >= channel.epoch
        for u in rng.integers(0, train.shape[0], MAX_BATCH):
            frontend.submit(int(u), topk=TOPK)
        for r in frontend.flush():
            served += 1
            if not epochs or r.epoch != epochs[-1]:
                epochs.append(r.epoch)
                print(f"  now serving epoch {r.epoch}  (top-1: item {r.items[0]}, "
                      f"score {r.scores[0]:.2f})")
        if done:
            break
    trainer.join()
    frontend.close()
    if trainer_error:
        raise trainer_error[0]
    lat = frontend.latency_percentiles()
    print(f"served {served} requests across {frontend.swaps} ensemble swaps; "
          f"request p50 {lat['p50'] * 1e3:.2f} ms")
    print(f"durable copies of the window: {len(store.steps())} draws")
    assert epochs == sorted(epochs) and epochs[-1] == channel.epoch
    return served, epochs


if __name__ == "__main__":
    main()
