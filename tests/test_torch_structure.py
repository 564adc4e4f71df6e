"""Structural rules of the port: it imports neither JAX nor the JAX
package, its serving tier does no device work under a lock (the port's
lint, `repro_torch.analysis`, sync-under-lock), and its entry
points (the distributed sampler's too) run on the card unless asked for
the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest-xdist runs several workers on the same cores,
# and torch's default thread count each would oversubscribe them
torch.set_num_threads(1)

from repro_torch.analysis import analyze_source  # noqa: E402
from repro_torch.checkpoint import RetainedSample  # noqa: E402
from repro_torch.core import GibbsSampler  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import synthetic_lowrank  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.models import DecoderModel, build_model  # noqa: E402
from repro_torch.launch import train as bpmf_train  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ClusterCoordinator,
    PosteriorEnsemble,
    PublicationChannel,
    RecommendFrontend,
    TopNRecommender,
)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 10
    assert {"core/partition.py", "core/exchange.py", "core/distributed.py", "core/als.py",
            "core/sgld.py", "optim/schedule.py", "optim/adamw.py", "runtime/__init__.py",
            "runtime/trainer.py", "launch/train.py", "configs/smollm_360m.py",
            "configs/stablelm_1_6b.py", "configs/granite_20b.py",
            "configs/granite_moe_3b_a800m.py", "configs/xlstm_350m.py",
            "configs/zamba2_7b.py", "models/ssm.py", "models/mamba.py",
            "models/zamba.py", "analysis/cli.py", "analysis/cuda.py"} <= {
        f.relative_to(PORT).as_posix() for f in files}
    bad = [
        (str(f.relative_to(ROOT)), root)
        for f in files + [ROOT / "chip_smoke.py", ROOT / "examples" / "train_lm_torch.py"]
        for root in _imported_roots(ast.parse(f.read_text()))
        if root in FORBIDDEN
    ]
    assert bad == []


def _device_calls_under_locks(code: str, filename: str):
    """(line, call) of each device call the port's lint flags under a lock
    (`repro_torch.analysis`'s sync-under-lock: a torch call, or a method
    that copies, syncs or builds device tables), suppressions honoured."""
    lines = code.splitlines()
    return [(f.line, lines[f.line - 1].strip()[:60])
            for f in analyze_source(code, rules=["sync-under-lock"], filename=filename)]


def test_no_device_work_under_a_serving_lock():
    files = sorted((PORT / "serve").glob("*.py"))
    assert {f.name for f in files} >= {"cluster.py", "frontend.py", "publish.py",
                                        "foldin.py", "faults.py"}
    bad = [(f.name, line, text) for f in files
           for line, text in _device_calls_under_locks(f.read_text(), f.name)]
    assert bad == []


def test_device_work_under_a_lock_is_caught():
    src = """
class C:
    def f(self, ens, t):
        with self._lock:
            a = ens.scoring_matrices()
            b = t.cpu()
            c = torch.zeros(3)
            d = t.to('cuda')  # repro-lint: disable=sync-under-lock (stop-the-world)
            self.n += 1
        e = t.item()
"""
    found = [line for line, _ in _device_calls_under_locks(src, "mod.py")]
    assert found == [5, 6, 7]


def _sample():
    rng = np.random.default_rng(0)
    k = 4
    return RetainedSample(
        step=1, u=rng.normal(size=(5, k)).astype(np.float32),
        v=rng.normal(size=(7, k)).astype(np.float32),
        hyper_u_mu=np.zeros(k, np.float32), hyper_u_lam=np.eye(k, dtype=np.float32),
        hyper_v_mu=np.zeros(k, np.float32), hyper_v_lam=np.eye(k, dtype=np.float32),
        global_mean=0.0, alpha=2.0,
    )


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card_and_raise_without_one(no_card):
    ratings, _, _ = synthetic_lowrank(20, 10, k_true=2, nnz=80, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GibbsSampler(ratings, k=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PosteriorEnsemble([_sample()])
    ens = PosteriorEnsemble([_sample()], device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TopNRecommender(ens)
    # asked for, the CPU runs the plain path end to end
    sampler = GibbsSampler(ratings, k=4, burn_in=0, engine="fused", device="cpu")
    state = sampler.run(2, seed=0)
    assert torch.isfinite(state.u).all() and state.u.device.type == "cpu"
    vals, idx = TopNRecommender(ens, device="cpu").recommend([0, 4], 3)
    assert idx.shape == (2, 3) and np.isfinite(vals).all()


def test_serving_tier_and_bpmf_launchers_raise_without_a_card(no_card):
    ens = PosteriorEnsemble([_sample()], device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClusterCoordinator(ens, n_hosts=2)
    ch = PublicationChannel(window=1)
    s = _sample()
    ch.publish(1, {k: getattr(s, k) for k in ("u", "v", "hyper_u_mu", "hyper_u_lam",
                                              "hyper_v_mu", "hyper_v_lam",
                                              "global_mean", "alpha")})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RecommendFrontend(channel=ch, subscribe=False)
    for argv in (["--bpmf", "--co-train", "--sweeps", "8"],
                 ["--bpmf", "--hosts", "4", "--replicas", "2"],
                 ["--bpmf", "--requests", "8"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lm_serve.main(argv)
    for argv in (["--bpmf", "--sweeps", "8"], ["--bpmf", "--co-serve", "--sweeps", "8"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bpmf_train.main(argv)
    fe = RecommendFrontend(channel=ch, subscribe=False, n_hosts=2, replicas=2,
                           device="cpu")
    fe.submit(0, topk=2)
    fe.submit_ratings([1, 3], [1.0, -1.0], topk=2)
    assert [r.items.shape for r in fe.flush()] == [(2,), (2,)]


@pytest.mark.parametrize("argv, report", [
    (["--bpmf", "--co-train", "--sweeps", "10"], "publish->fresh p50"),
    (["--bpmf", "--hosts", "4", "--replicas", "2"], "publish -> all-shards-fresh p50"),
])
def test_bpmf_launchers_run_on_the_cpu_when_asked(argv, report):
    # one intra-op thread: the launcher's own threads share the cores the
    # other test workers use
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv, "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert report in out.stdout and "qps" in out.stdout
    if "--hosts" in argv:
        assert "bit-identical" in out.stdout and "degraded parity" in out.stdout


def test_distributed_sampler_defaults_to_the_card_and_raises_without_one(no_card):
    from repro_torch.core.distributed import DistributedBPMF, shard_devices

    ratings, _, _ = synthetic_lowrank(20, 10, k_true=2, nnz=80, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistributedBPMF(ratings, k=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistributedBPMF(ratings, k=4, devices=["cuda"] * 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shard_devices(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bpmf_train.main(["--bpmf", "--mode", "ring", "--shards", "2", "--sweeps", "2"])
    # asked for, the CPU runs the plain path end to end
    d = DistributedBPMF(ratings, k=4, devices=shard_devices(2, "cpu"), mode="async",
                        engine="fused")
    state = d.run(2, seed=0)
    assert all(torch.isfinite(x).all() and x.device.type == "cpu" for x in state.u)


def test_als_and_sgld_default_to_the_card_and_raise_without_one(no_card):
    from repro_torch.core import ALS, DistributedSGLD, SGLDSampler
    from repro_torch.core.distributed import shard_devices

    ratings, _, _ = synthetic_lowrank(20, 10, k_true=2, nnz=80, seed=0)
    for cls in (ALS, SGLDSampler, DistributedSGLD):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(ratings, k=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistributedSGLD(ratings, k=4, devices=["cuda"] * 2)
    for argv in (["--bpmf", "--engine", "sgld", "--sweeps", "2"],
                 ["--bpmf", "--engine", "sgld", "--mode", "async", "--shards", "2"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bpmf_train.main(argv)
    # asked for, the CPU runs them end to end
    assert np.isfinite(ALS(ratings, k=4, device="cpu").run(2).u.numpy()).all()
    s = SGLDSampler(ratings, k=4, burn_in=1, device="cpu")
    assert s.run(3, seed=0).u.device.type == "cpu"
    d = DistributedSGLD(ratings, k=4, devices=shard_devices(2, "cpu"), mode="async")
    assert all(torch.isfinite(x).all() for x in d.run(3, seed=0).u)


def test_lm_entry_points_default_to_the_card_and_raise_without_one(no_card):
    cfg = reduced(get_config("gemma2-2b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecoderModel(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_serve.main(["--arch", "gemma2-2b", "--reduced", "--batch", "1",
                       "--prompt-len", "4", "--max-new", "2"])
    model = DecoderModel(cfg, device="cpu")
    out = model.prefill_fn(model.init(seed=0), {"tokens": np.zeros((1, 4), np.int32)})
    assert out["logits"].device.type == "cpu" and torch.isfinite(out["logits"]).all()


@pytest.mark.parametrize("name", ["xlstm-350m", "zamba2-7b"])
def test_ssm_and_hybrid_entry_points_default_to_the_card(name, no_card):
    from repro_torch.models import XLSTMModel, ZambaModel

    cfg = reduced(get_config(name))
    kind = XLSTMModel if cfg.family == "ssm" else ZambaModel
    for make in (kind, build_model):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_serve.main(["--arch", name, "--reduced", "--batch", "1", "--prompt-len", "4",
                       "--max-new", "2"])
    model = build_model(cfg, device="cpu")
    assert type(model) is kind
    out = model.prefill_fn(model.init(seed=0), {"tokens": np.zeros((1, 4), np.int32)})
    assert out["logits"].device.type == "cpu" and torch.isfinite(out["logits"]).all()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        DecoderModel(cfg, device="cpu")


@pytest.mark.parametrize("name", ["whisper-medium", "qwen2-vl-7b"])
def test_audio_and_vlm_entry_points_default_to_the_card(name, no_card):
    """build_model gives whisper's EncDecModel and qwen2-vl's DecoderModel,
    each raising without a card unless asked for the CPU, where a prefill
    with the stubs' inputs (the launcher's) runs."""
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models import EncDecModel

    cfg = reduced(get_config(name))
    kind = EncDecModel if cfg.family == "audio" else DecoderModel
    for make in (kind, build_model):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_serve.main(["--arch", name, "--reduced", "--batch", "1", "--prompt-len", "4",
                       "--max-new", "2"])
    model = build_model(cfg, device="cpu")
    assert type(model) is kind
    inputs = stub_inputs(cfg, 1, 4, torch.Generator().manual_seed(0))
    out = model.prefill_fn(model.init(seed=0), {"tokens": np.zeros((1, 4), np.int32), **inputs})
    assert out["logits"].device.type == "cpu" and torch.isfinite(out["logits"]).all()


def test_lm_training_defaults_to_the_card_and_raises_without_one(no_card):
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig

    cfg = reduced(get_config("gemma2-2b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg, 0, AdamWConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg, AdamWConfig())
    # asked for, the CPU takes a step
    state = init_train_state(cfg, 0, AdamWConfig(), device="cpu")
    step = make_train_step(cfg, AdamWConfig(), total_steps=5, device="cpu")
    batch = {"tokens": np.zeros((1, 8), np.int32), "labels": np.ones((1, 8), np.int32)}
    state, metrics = step(state, batch)
    assert int(state.step) == 1 and np.isfinite(float(metrics["loss"]))
    assert all(p.device.type == "cpu" and p.grad is None for p in state.params.parameters())


def test_lm_launcher_runs_on_the_cpu_when_asked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma2-2b",
         "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "16",
         "--max-new", "4"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "arch=gemma2-2b batch=2 prompt=16 device=cpu" in out.stdout
    assert "prefill:" in out.stdout and "decode:" in out.stdout


@pytest.mark.parametrize("name", ["gemma2-2b", "smollm-360m", "stablelm-1.6b", "granite-20b",
                                  "granite-moe-3b-a800m", "xlstm-350m", "zamba2-7b",
                                  "whisper-medium", "qwen2-vl-7b", "kimi-k2-1t-a32b"])
def test_config_registry_matches_the_jax_registry(name):
    """Every config the port registers is the JAX package's, field for
    field (dtypes by name), in full and in `reduced`, and lacks no field of
    the JAX config: the moments' dtype and the pod-axis sharding (which
    has no effect without a mesh) are carried too."""
    import dataclasses

    from repro.configs import REGISTRY as JREGISTRY, reduced as jreduced
    from repro_torch.configs import REGISTRY

    assert name in REGISTRY and set(REGISTRY) <= set(JREGISTRY)
    for port, ref in ((REGISTRY[name], JREGISTRY[name]),
                      (reduced(REGISTRY[name]), jreduced(JREGISTRY[name]))):
        for f in dataclasses.fields(port):
            want = getattr(ref, f.name)
            got = getattr(port, f.name)
            if f.name.endswith("dtype"):
                got, want = str(got).split(".")[-1], np.dtype(want).name
            assert got == want, (name, f.name)
        assert (port.hd, port.is_moe) == (ref.hd, ref.is_moe)
        missing = {f.name for f in dataclasses.fields(ref)} - {
            f.name for f in dataclasses.fields(port)}
        assert missing == set(), missing


@pytest.mark.parametrize("name", ["smollm-360m", "stablelm-1.6b", "granite-20b",
                                  "granite-moe-3b-a800m", "xlstm-350m", "zamba2-7b",
                                  "whisper-medium", "qwen2-vl-7b"])
def test_lm_launcher_serves_each_ported_arch_on_the_cpu(name, capsys):
    lm_serve.main(["--arch", name, "--reduced", "--device", "cpu", "--batch", "2",
                   "--prompt-len", "16", "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"arch={name} batch=2 prompt=16 device=cpu" in out and "decode:" in out
