"""Structural rules of the port: it imports neither JAX nor the JAX
package, and its entry points run on the card unless asked for the CPU."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import RetainedSample  # noqa: E402
from repro_torch.core import GibbsSampler  # noqa: E402
from repro_torch.data import synthetic_lowrank  # noqa: E402
from repro_torch.serve import PosteriorEnsemble, TopNRecommender  # noqa: E402

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
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
