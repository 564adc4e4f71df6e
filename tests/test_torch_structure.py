"""Structural rules of the port: it imports neither JAX nor the JAX
package, and its entry points run on the card unless asked for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import RetainedSample  # noqa: E402
from repro_torch.core import GibbsSampler  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import synthetic_lowrank  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.models import DecoderModel, build_model  # noqa: E402
from repro_torch.serve import PosteriorEnsemble, TopNRecommender  # noqa: E402

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
    bad = [
        (str(f.relative_to(PORT)), root)
        for f in files
        for root in _imported_roots(ast.parse(f.read_text()))
        if root in FORBIDDEN
    ]
    assert bad == []


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
