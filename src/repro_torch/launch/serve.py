"""Serving launcher of the port: LM decode serving and BPMF recommendation
serving, as `repro/launch/serve.py` runs them.

LM mode, batched prefill then greedy (or sampled) decode:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --batch 4 --prompt-len 2048 --max-new 32

runs on the card; add `--reduced --device cpu` for the CPU-sized
miniature on the plain path. `--arch` takes every architecture the port
has: gemma2-2b, smollm-360m, stablelm-1.6b, granite-20b,
granite-moe-3b-a800m, xlstm-350m, zamba2-7b, whisper-medium and
qwen2-vl-7b (`models.build_model` picks the model of the config's
family). Parameters are drawn from seed 0 and the prompts from seed 1
(torch.Generator; not the JAX launcher's numbers), and so are the
modality stubs' inputs, as the JAX launcher builds them: whisper's
encoder_seq frame embeddings and qwen2-vl's n_patches patch embeddings
(each 0.1 times a standard normal), the VLM's prefill positions 0 ..
n_patches + P - 1 on its three M-RoPE channels, and each decode step's
the next one. Prefill and decode take the direct attention path, so the
flash kernel does not run here.

BPMF mode, top-N from retained Gibbs draws through the request-batching
frontend, reporting queries/s and p50/p99 latency (without --samples it
trains a small synthetic model first):

    PYTHONPATH=src python -m repro_torch.launch.serve --bpmf --requests 256

Co-train mode: a trainer thread runs the Gibbs chain and publishes every
retained draw into a PublicationChannel; the frontend adopts each publish
in memory while request traffic flows, and the run reports publish ->
first-fresh-recommendation latency beside the queries/s:

    PYTHONPATH=src python -m repro_torch.launch.serve --bpmf --co-train

Tier mode: N shard hosts (ClusterCoordinator, each with its own subscriber
thread) serve while a publisher thread pushes fresh epochs; the run checks
that the tier serves top-N bit-identical to the single-host recommender and
that served epochs stay monotone (the quorum barrier). With --replicas 2 it
also kills one host and checks that serving stays bit-identical and the
publishes still commit:

    PYTHONPATH=src python -m repro_torch.launch.serve --bpmf --hosts 4 --replicas 2

Every BPMF mode runs on the card ("--device cpu" for the plain path). Tier
mode places its hosts with `launch.mesh.serving_host_devices(n_hosts=)`:
over every visible card, cycled, so on one card all hosts share cuda:0
(the reference instead re-executes itself under forced host devices).
BPMF mode takes the frontend's default devices, every visible card (the
reference's `make_host_mesh()` there names only this process's card under
torch, one process a rank). The demo trainers sweep
with the fused engine and cold-start requests fold in through it, so on
the card both run the gather_syrk_seg kernel (`launch.train --engine`
picks another).
"""
from __future__ import annotations

import argparse
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.models import DecoderModel, EncDecModel, XLSTMModel, ZambaModel, build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: DecoderModel | EncDecModel | XLSTMModel | ZambaModel, params,
             prompts: torch.Tensor, max_new: int, *, inputs: dict | None = None,
             temperature: float = 0.0, generator: torch.Generator | None = None
             ) -> tuple[torch.Tensor, float, float]:
    """Prefill `prompts` (B, P) with the modality stubs' `inputs` (whisper's
    "frames"; the VLM's "patch_embeds" and (B, 3, S) "positions"), then
    max_new - 1 decode steps. A VLM decode step's M-RoPE position is one
    past the row's largest prefill position, then one more each step (on
    all three channels: Qwen2-VL's rule for text after the patches).

    Returns (the max_new new tokens (B, max_new), prefill seconds, decode
    seconds); greedy at temperature 0, else sampled from softmax(logits / T).
    """
    dev = model.device
    inputs = inputs or {}
    _sync(dev)
    t0 = time.perf_counter()
    # a cache that grows (K/V buffers) is sized for the new tokens; the
    # xLSTM's states are of a fixed size and its prefill takes no headroom
    kw = {"headroom": max_new + 8} if model.cache_grows else {}
    out = model.prefill_fn(params, {"tokens": prompts, **inputs}, **kw)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    def pick(logits):
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator).to(torch.int32)
        return logits.argmax(-1, keepdim=True).to(torch.int32)

    cache = out["cache"]
    tok = pick(out["logits"])
    toks = [tok]
    pos0 = None
    if "positions" in inputs:
        nxt = torch.as_tensor(inputs["positions"], device=dev).amax(dim=(1, 2)) + 1
        pos0 = nxt.to(torch.int32)[:, None, None].expand(-1, 3, 1)
    t0 = time.perf_counter()
    for i in range(max_new - 1):
        step = {"tokens": tok}
        if pos0 is not None:
            step["positions"] = pos0 + i
        cache, logits = model.decode_fn(params, cache, step)
        tok = pick(logits)
        toks.append(tok)
    _sync(dev)
    return torch.cat(toks, dim=1), t_prefill, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# BPMF modes
# ---------------------------------------------------------------------------
def _demo_data(scale: float, seed: int):
    from repro_torch.data import movielens_like, train_test_split

    ratings, _, _ = movielens_like(scale=scale, seed=seed)
    return train_test_split(ratings, 0.1, seed=seed + 1)


def train_demo_samples(root: str, *, seed: int = 0, device="cuda"):
    """Train a small synthetic BPMF model and retain draws under `root`.
    Returns the training ratings (the serving side's seen-item index)."""
    from repro_torch.checkpoint import SampleStore
    from repro_torch.core import GibbsSampler

    train, test = _demo_data(0.002, seed)
    sampler = GibbsSampler(train, test, k=16, alpha=4.0, burn_in=6,
                           widths=(8, 32, 128), engine="fused", device=device)
    sampler.run(14, seed=seed, store=SampleStore(root, keep=8))
    return train


def run_train_and_serve(*, scale: float = 0.01, sweeps: int = 60, k: int = 16,
                        burn_in: int = 6, window: int = 4, samples: str | None = None,
                        topk: int = 10, max_batch: int = 8, seed: int = 0,
                        engine: str = "fused", device="cuda",
                        verbose: bool = True) -> dict:
    """Train and serve in one process with overlapped sample publication.

    A trainer thread runs the Gibbs chain and publishes every retained draw
    into a PublicationChannel (and, with `samples`, also writes it through
    a SampleStore). The calling thread serves top-N traffic throughout, a
    cold-start request among every batch; the frontend's subscriber thread
    adopts each publish. Returns the metrics it prints: requests served,
    draws published, swaps, rebinds and publish -> first fresh
    recommendation latency.
    """
    from repro_torch.checkpoint import SampleStore
    from repro_torch.core import GibbsSampler
    from repro_torch.serve import PublicationChannel, RecommendFrontend

    if sweeps <= burn_in:
        raise ValueError(f"need sweeps > burn_in to publish anything "
                         f"({sweeps} <= {burn_in})")
    train, test = _demo_data(scale, seed)
    sampler = GibbsSampler(train, test, k=k, alpha=4.0, burn_in=burn_in,
                           widths=(8, 32, 128), engine=engine, device=device)
    channel = PublicationChannel(window=window)
    store = SampleStore(samples, keep=window) if samples else None
    if verbose:
        print(f"co-train: {train.shape[0]} x {train.shape[1]} ratings matrix, "
              f"{sweeps} sweeps (burn-in {burn_in}), k={k}, window={window}, "
              f"engine={engine}, device={sampler.device}"
              + (f", durable store {samples}" if samples else ""))

    trainer_error: list[BaseException] = []

    def train_loop():
        try:
            sampler.run(sweeps, seed=seed, store=store, publish=channel)
        except BaseException as e:  # noqa: BLE001 - raised after the join
            trainer_error.append(e)
        finally:
            channel.close()  # always ends the serving loop's drain

    trainer = threading.Thread(target=train_loop, name="gibbs-trainer")
    trainer.start()
    try:
        fe = RecommendFrontend(channel=channel, seen=train, max_batch=max_batch,
                               engine=engine, device=device)
    except Exception:
        trainer.join()  # the root cause, not the closed channel
        if trainer_error:
            raise trainer_error[0]
        raise

    rng = np.random.default_rng(seed)
    cold = train.cols[train.rows == 0], train.vals[train.rows == 0]
    served = 0
    fresh_lat: list[float] = []        # publish -> first fresh recommendation
    seen_epochs: list[int] = []
    t0 = time.perf_counter()
    while True:
        drained = channel.closed and fe.epoch >= (channel.epoch or 0)
        for u in rng.integers(0, train.shape[0], max_batch - 1):
            fe.submit(int(u), topk=topk)
        fe.submit_ratings(*cold, topk=topk)   # user 0's ratings, as a new user
        results = fe.flush()
        served += len(results)
        t_now = time.perf_counter()
        for r in results:
            if not seen_epochs or r.epoch > seen_epochs[-1]:
                seen_epochs.append(r.epoch)
                t_pub = channel.publish_time(r.epoch)
                if t_pub is not None and len(seen_epochs) > 1:
                    fresh_lat.append(t_now - t_pub)
        if drained:
            break
    dt = time.perf_counter() - t0
    trainer.join()
    fe.close()
    if trainer_error:
        raise trainer_error[0]
    if seen_epochs != sorted(seen_epochs):
        raise AssertionError(f"served epochs regressed: {seen_epochs}")

    lat = fe.latency_percentiles()
    metrics = {
        "served": served,
        "qps": served / dt,
        "published": channel.seq,
        "epochs_served": len(seen_epochs),
        "swaps": fe.swaps,
        "rebinds": fe.rebinds,
        "request_p50_ms": lat["p50"] * 1e3,
        "request_p99_ms": lat["p99"] * 1e3,
        "fresh_p50_ms": float(np.median(fresh_lat) * 1e3) if fresh_lat else float("nan"),
        "fresh_max_ms": float(np.max(fresh_lat) * 1e3) if fresh_lat else float("nan"),
    }
    if verbose:
        print(f"served {served} requests in {dt:.2f}s -> {metrics['qps']:,.0f} qps "
              f"while {channel.seq} draws were published; served "
              f"{len(seen_epochs)} distinct epochs "
              f"({fe.swaps} swaps, {fe.rebinds} rebinds)")
        print(f"request p50 {metrics['request_p50_ms']:.2f} ms  "
              f"p99 {metrics['request_p99_ms']:.2f} ms;  publish->fresh "
              f"p50 {metrics['fresh_p50_ms']:.1f} ms  "
              f"max {metrics['fresh_max_ms']:.1f} ms")
    return metrics


def _sample_dict(s) -> dict:
    """A RetainedSample as the flat SAMPLE_KEYS dict a publish takes."""
    return {"u": s.u, "v": s.v, "hyper_u_mu": s.hyper_u_mu,
            "hyper_u_lam": s.hyper_u_lam, "hyper_v_mu": s.hyper_v_mu,
            "hyper_v_lam": s.hyper_v_lam,
            "global_mean": np.float32(s.global_mean), "alpha": np.float32(s.alpha)}


def run_cluster(*, hosts: int = 2, replicas: int = 1, samples: str | None = None,
                requests: int = 256, topk: int = 10, max_batch: int = 8,
                publishes: int = 4, seed: int = 0, device="cuda",
                verbose: bool = True) -> dict:
    """Drive the serving tier against live traffic and publishes.

    Builds an N-host ClusterCoordinator attached to a channel and a
    single-host TopNRecommender over the same ensemble and checks that the
    tier's top-N is bit-identical; then serves `requests` warm-user batches
    while a publisher thread pushes `publishes` fresh same-shape epochs,
    checking that served epochs never go back. With replicas > 1 it kills
    one host before the publishes: serving must stay bit-identical and every
    publish must still commit. Returns the metrics it prints.
    """
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import serving_host_devices
    from repro_torch.serve import (
        ClusterCoordinator,
        PosteriorEnsemble,
        PublicationChannel,
        TopNRecommender,
    )

    device = resolve_device(device)
    root = samples
    if root is None:
        root = tempfile.mkdtemp(prefix="bpmf_samples_")
        if verbose:
            print(f"no --samples given; training a demo model into {root}")
        train_demo_samples(root, seed=seed, device=device)
    ensemble = PosteriorEnsemble.load(root, device=device)
    devices = serving_host_devices(n_hosts=hosts, device=device)
    if verbose:
        print(f"cluster: {hosts} hosts, replicas={replicas}, on "
              f"{[str(d) for d in devices]}; "
              f"ensemble S={ensemble.n_samples} {ensemble.n_users}x"
              f"{ensemble.n_items} k={ensemble.k} epoch={ensemble.epoch}")

    single = TopNRecommender(ensemble, device=device)
    channel = PublicationChannel(window=ensemble.n_samples)
    for s in ensemble.samples:
        channel.publish(s.step, _sample_dict(s))
    cluster = ClusterCoordinator(ensemble, devices=devices, replicas=replicas,
                                 device=device, channel=channel)
    try:
        # the tier must match the single host bit for bit
        rng = np.random.default_rng(seed)
        probe = rng.integers(0, ensemble.n_users, max_batch).astype(np.int32)
        v1, i1 = single.recommend(probe, topk)
        v2, i2 = cluster.recommend(probe, topk)
        identical = bool(np.array_equal(i1, i2) and np.array_equal(v1, v2))
        if not identical:
            raise AssertionError(
                f"cluster top-N diverged from single-host: items equal="
                f"{np.array_equal(i1, i2)} values equal={np.array_equal(v1, v2)}")
        if verbose:
            print(f"parity: {hosts}-host tier bit-identical to the single-host "
                  f"TopNRecommender over {max_batch} probe users (topk={topk})")

        # degraded mode: one host down, the tier must not notice
        if replicas > 1:
            cluster.health.kill(cluster.hosts[0].host_id)
            v3, i3 = cluster.recommend(probe, topk)
            if not (np.array_equal(i1, i3) and np.array_equal(v1, v3)):
                raise AssertionError("degraded tier (1 host down) diverged from "
                                     "single-host")
            if verbose:
                print(f"degraded parity: host 0 killed, replicas={replicas}: "
                      "still bit-identical; publishes must commit past the "
                      "dead host (quorum barrier)")

        # serve while a publisher pushes fresh epochs
        base = ensemble.samples[-1]

        def publisher():
            p_rng = np.random.default_rng(seed + 1)
            try:
                for i in range(publishes):
                    d = _sample_dict(base)
                    for key in ("u", "v"):
                        noise = p_rng.normal(size=np.shape(d[key])).astype(np.float32)
                        d[key] = d[key] + 0.01 * noise
                    channel.publish(ensemble.epoch + 1 + i, d)
                    time.sleep(0.05)  # spread the publishes over the traffic
            finally:
                channel.close()

        pub = threading.Thread(target=publisher, name="cluster-publisher")
        pub.start()
        served = 0
        epochs_seen: list[int] = []
        t0 = time.perf_counter()
        deadline = t0 + 300.0  # a wedged barrier fails loudly
        while True:
            if time.perf_counter() > deadline:
                raise TimeoutError(f"cluster stuck at epoch {cluster.epoch} < "
                                   f"{channel.epoch}")
            drained = channel.closed and cluster.epoch >= (channel.epoch or 0)
            users = rng.integers(0, ensemble.n_users, max_batch).astype(np.int32)
            epoch = cluster.epoch
            cluster.recommend(users, topk)
            served += len(users)
            if not epochs_seen or epoch != epochs_seen[-1]:
                epochs_seen.append(epoch)
            if drained and served >= requests:
                break
        dt = time.perf_counter() - t0
        pub.join()
    finally:
        cluster.close()
    if epochs_seen != sorted(epochs_seen):
        raise AssertionError(f"served epochs regressed: {epochs_seen}")

    fresh = cluster.freshness_percentiles()
    metrics = {
        "hosts": hosts,
        "replicas": replicas,
        "served": served,
        "qps": served / dt,
        "bit_identical": identical,
        "commits": cluster.commits,
        "reassignments": cluster.reassignments,
        "epochs_served": len(epochs_seen),
        "fresh_p50_ms": fresh["p50"] * 1e3,
        "fresh_p99_ms": fresh["p99"] * 1e3,
        "fresh_max_ms": fresh["max"] * 1e3,
    }
    if verbose:
        print(f"served {served} requests in {dt:.2f}s -> {metrics['qps']:,.0f} qps "
              f"across {len(epochs_seen)} monotone epochs "
              f"({cluster.commits} barrier commits)")
        print(f"publish -> all-shards-fresh p50 {metrics['fresh_p50_ms']:.1f} ms  "
              f"p99 {metrics['fresh_p99_ms']:.1f} ms  "
              f"max {metrics['fresh_max_ms']:.1f} ms")
    return metrics


def bpmf_main(args) -> None:
    from repro_torch.serve import RecommendFrontend

    if args.co_train:
        run_train_and_serve(sweeps=args.sweeps, samples=args.samples, topk=args.topk,
                            window=args.keep, max_batch=args.max_batch,
                            device=args.device)
        return

    seen = None
    root = args.samples
    if root is None:
        root = tempfile.mkdtemp(prefix="bpmf_samples_")
        print(f"no --samples given; training a demo model into {root}")
        seen = train_demo_samples(root, device=args.device)

    fe = RecommendFrontend(root, seen=seen, max_batch=args.max_batch,
                           engine="fused", device=args.device)
    ens = fe.ensemble
    print(f"ensemble: {ens.n_samples} samples, {ens.n_users} users x "
          f"{ens.n_items} items, k={ens.k}, epoch={fe.epoch} (device {fe.device}, "
          f"{len(fe.devices)} shard device(s))")

    users = np.random.default_rng(0).integers(0, ens.n_users, args.requests)
    # warm up at the serving batch size before timing
    for u in users[: args.max_batch]:
        fe.submit(int(u), topk=args.topk)
    fe.flush()
    fe.latencies_s.clear()
    t0 = time.perf_counter()
    served = 0
    for u in users:
        fe.submit(int(u), topk=args.topk)
        if fe.pending >= args.max_batch:
            served += len(fe.flush())
    served += len(fe.flush())
    dt = time.perf_counter() - t0
    lat = fe.latency_percentiles()
    print(f"served {served} requests in {dt:.3f}s -> {served/dt:,.0f} qps  "
          f"p50 {lat['p50']*1e3:.2f} ms  p99 {lat['p99']*1e3:.2f} ms")


def stub_inputs(cfg, batch: int, prompt_len: int, generator: torch.Generator) -> dict:
    """The modality stubs' prefill inputs beside `batch` prompts of
    `prompt_len` tokens, as the JAX launcher builds them: whisper's
    (B, encoder_seq, D) frames, or the VLM's (B, n_patches, D) patch
    embeddings, each 0.1 times a standard normal from `generator`, and its
    positions 0 .. n_patches + prompt_len - 1 on all three channels; {}
    for the other families."""
    dev = generator.device
    if cfg.family == "audio":
        return {"frames": 0.1 * torch.randn(batch, cfg.encoder_seq, cfg.d_model,
                                            generator=generator, device=dev)}
    if cfg.family == "vlm":
        total = cfg.n_patches + prompt_len
        return {"patch_embeds": 0.1 * torch.randn(batch, cfg.n_patches, cfg.d_model,
                                                  generator=generator, device=dev),
                "positions": torch.arange(total, dtype=torch.int32,
                                          device=dev).expand(batch, 3, total)}
    return {}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b",
                    help="an architecture of repro_torch.configs.REGISTRY")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain path")
    ap.add_argument("--bpmf", action="store_true",
                    help="serve BPMF recommendations instead of an LM")
    ap.add_argument("--samples", default=None,
                    help="SampleStore directory of retained Gibbs draws")
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--co-train", action="store_true",
                    help="train and serve in one process; retained draws are "
                         "pushed to the live frontend (no disk poll)")
    ap.add_argument("--hosts", type=int, default=0,
                    help="serve through the tier with N shard hosts over the "
                         "visible devices, cycled")
    ap.add_argument("--publishes", type=int, default=4,
                    help="--hosts mode: fresh epochs pushed mid-stream")
    ap.add_argument("--replicas", type=int, default=1,
                    help="--hosts mode: owners per item shard; with R > 1 the "
                         "run kills one host and checks that serving stays "
                         "bit-identical and publishes still commit")
    ap.add_argument("--sweeps", type=int, default=60,
                    help="co-train: total Gibbs sweeps")
    ap.add_argument("--keep", type=int, default=4,
                    help="co-train: publication window / ensemble size")
    args = ap.parse_args(argv)

    if args.bpmf and args.hosts > 0:
        run_cluster(hosts=args.hosts, replicas=args.replicas, samples=args.samples,
                    requests=args.requests, topk=args.topk,
                    max_batch=min(args.max_batch, 8), publishes=args.publishes,
                    device=args.device)
        return
    if args.bpmf:
        bpmf_main(args)
        return

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = build_model(cfg, device=args.device)
    params = model.init(seed=0)
    gen = torch.Generator(device=model.device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=model.device, dtype=torch.int32)
    gen_toks, t_prefill, t_decode = generate(model, params, prompts, args.max_new,
                                             inputs=stub_inputs(cfg, args.batch,
                                                                args.prompt_len, gen),
                                             temperature=args.temperature, generator=gen)
    n_tok = args.batch * (args.max_new - 1)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"device={model.device}")
    print(f"prefill: {t_prefill * 1e3:.0f} ms   decode: {n_tok / max(t_decode, 1e-9):,.0f} tok/s")
    print("sample:", gen_toks[0][:16].tolist(), "...")


if __name__ == "__main__":
    main()
