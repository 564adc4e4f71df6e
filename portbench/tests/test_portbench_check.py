"""The check on the CPU at a tiny size: the references against the port's
CPU path, the controls in lower precision failing, and each planted fault
making a run's `correct` false.

The limits are the cells' own (`portbench/limits`), set from readings at
the cells' sizes on the card.
"""
from __future__ import annotations

import pytest
import torch

from tiny import tiny_root

from portbench import faults
from portbench.harness import cell, spec
from portbench.reference import bpmf
from portbench.reference.arith import Arith, to_tf32

SEED = 3 * 2**31 + 1
CELLS = {"chembl.train": "gibbs", "ml20m.train": "gibbs", "ml20m.topn": "topn"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def _driver(root, workload):
    c = spec.cell(workload, root)
    drv = spec.driver(c.traffic, root).Driver(c.config, c.traffic, SEED, "cpu",
                                              cell.Spans("cpu"))
    cell._window(drv, 0.2, "cpu")
    return c, drv


def _fails(numbers: dict, limits: dict) -> list:
    return [n for n, lim in limits.items() if not numbers[n] <= lim]


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_port(root, workload):
    c, drv = _driver(root, workload)
    numbers = drv.check()
    assert c.limits and set(c.limits) <= set(numbers)
    assert _fails(numbers, c.limits) == []
    assert drv.failed == 0


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_lower_precision_fails(root, workload, precision):
    c, drv = _driver(root, workload)
    drv.release()
    numbers = drv.judge(drv.control(precision), drv.reference())
    assert _fails(numbers, c.limits), numbers


@pytest.mark.parametrize("workload", ["chembl.train", "ml20m.train"])
def test_program_bf16_gather_fails(root, workload):
    c, drv = _driver(root, workload)
    drv.sampler.bf16_gather = True
    numbers = drv.judge(drv.rerun(), drv.reference())
    assert _fails(numbers, c.limits), numbers


@pytest.mark.parametrize("workload,fault",
                         [(w, f) for w, kind in CELLS.items() for f in faults.FAULTS[kind]])
def test_planted_fault_makes_a_run_incorrect(root, workload, fault):
    """A whole run on the CPU, the card's look skipped, with the fault
    under the timed path."""
    with faults.plant(CELLS[workload], fault):
        r = cell.run(workload, SEED, 0.2, False, device="cpu", root=root, log=lambda s: None)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("workload", ["chembl.train", "ml20m.train"])
@pytest.mark.parametrize("fault", faults.FAULTS["gibbs"])
def test_fault_in_the_window_alone_makes_the_check_fail(root, workload, fault):
    """A sweep that goes wrong only after set-up, as a stale cache or a
    captured graph would: the window's last sweep is judged too."""
    c, drv = _driver(root, workload)
    assert _fails(drv.check(), c.limits) == []
    drv.window = None
    with faults.plant("gibbs", fault):
        cell._window(drv, 0.2, "cpu")
    drv.release()
    assert _fails(drv.check(), c.limits), fault


def test_chunked_statistics_are_the_per_target_sums():
    g = torch.Generator().manual_seed(0)
    n_targets, n_src, k = 7, 50, 5
    degree = [0, 1, 31, 32, 33, 100, 3]
    target = torch.cat([torch.full((d,), t) for t, d in enumerate(degree)])
    perm = torch.randperm(target.shape[0], generator=g)
    target = target[perm]
    source = torch.randint(0, n_src, target.shape, generator=g)
    vals = torch.randn(target.shape, generator=g, dtype=torch.float64)
    cp = torch.randn((n_src, k), generator=g, dtype=torch.float64)
    s = bpmf.side(target, source, vals, n_targets)
    for block in (1, 2, 1 << 16):
        gram, rhs = bpmf.statistics(cp, s, Arith("float64"), block=block)
        for t in range(n_targets):
            x, r = cp[source[target == t]], vals[target == t]
            assert torch.allclose(gram[t], x.T @ x) and torch.allclose(rhs[t], x.T @ r)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-11,
                      3.0e38, float("inf")])
    assert to_tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, -1.0,
                                   to_tf32(torch.tensor([3.0e38])).item(), float("inf")]
    y = torch.randn(1000)
    err = ((to_tf32(y) - y).abs() / y.abs()).max()
    assert 0 < err <= 2**-11
    assert Arith("float64").mm(torch.eye(2), torch.eye(2)).dtype == torch.float64
