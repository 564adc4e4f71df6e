"""The port's examples run end to end on the CPU (`--device cpu`) at their
smallest sizes: each goes through the port's entry points and checks its
own result (finite recommendations, ring and allgather sampling alike, a
frontend that served every publish in order, the decode cache invariant).
Without `--device` each runs on the card, and raises where there is none;
none imports JAX or the JAX package."""
import ast
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest-xdist runs several workers on the same cores,
# and torch's default thread count each would oversubscribe them
torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TORCH_EXAMPLES = ("recommend_torch", "train_and_serve_torch", "distributed_bpmf_torch",
                  "serve_decode_torch")


def _example(name):
    sys.path.insert(0, str(EXAMPLES))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(EXAMPLES))


def test_recommend_torch_runs_on_the_cpu():
    vals, cvals = _example("recommend_torch").main(
        ["--device", "cpu", "--scale", "0.002", "--sweeps", "10"])
    assert vals.shape == (4, 10) and cvals.shape == (1, 10)


def test_train_and_serve_torch_runs_on_the_cpu():
    served, epochs = _example("train_and_serve_torch").main(
        ["--device", "cpu", "--scale", "0.003", "--sweeps", "12"])
    assert served > 0 and epochs[-1] == 12


def test_distributed_bpmf_torch_runs_on_the_cpu():
    results = _example("distributed_bpmf_torch").main(
        ["--device", "cpu", "--scale", "0.002", "--sweeps", "2"])
    assert set(results) == {"ring", "allgather"}
    assert all(np.isfinite(rmse) for _, rmse in results.values())


@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-moe-3b-a800m", "whisper-medium",
                                  "qwen2-vl-7b"])
def test_serve_decode_torch_runs_on_the_cpu(arch):
    new, agree = _example("serve_decode_torch").main(
        ["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "16",
         "--tokens", "8"])
    assert new.shape == (2, 8) and agree == 1.0


def test_torch_examples_import_neither_jax_nor_the_jax_package():
    roots = set()
    for name in TORCH_EXAMPLES:
        for node in ast.walk(ast.parse((EXAMPLES / f"{name}.py").read_text())):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots and not roots & {"jax", "jaxlib", "repro"}


@pytest.mark.parametrize("name", TORCH_EXAMPLES)
def test_torch_examples_default_to_the_card_and_raise_without_one(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(name).main(["--scale", "0.002"] if name != "serve_decode_torch" else [])
