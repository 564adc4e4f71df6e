"""The port's ALS baseline against the JAX package's, on the CPU: two sweeps
of `repro_torch.core.ALS` from the reference's own initial factors against
`repro.core.ALS`, and the reference's gate (tests/test_bpmf.py::
test_bpmf_beats_or_matches_als) on the port: Gibbs no worse than ALS with an
untuned lambda, + 0.02 RMSE.

Data: tests/test_bpmf.py's `small_data`, `synthetic_lowrank(250, 180,
k_true=8, nnz=8000, noise=0.3, seed=1)` split 0.1 with seed 2.

Tolerances, and why: the factors after two sweeps rtol 1e-4, atol 1e-3, the
port's half-sweep tolerance (tests/test_torch_gibbs.py): fp32 statistics
and Cholesky solves in another library's order; the rating counts of the
ALS-WR regulariser are integers, equal.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: pytest-xdist runs several workers on the same cores,
# and torch's default thread count each would oversubscribe them
torch.set_num_threads(1)

from repro.core import ALS as JALS  # noqa: E402
from repro.data import synthetic_lowrank, train_test_split  # noqa: E402
from repro_torch.core import ALS, GibbsSampler  # noqa: E402
from repro_torch.core.als import als_state_from_numpy  # noqa: E402
from repro_torch.data import SparseRatings  # noqa: E402

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-3)
WIDTHS = (8, 32, 128)


def _port(r) -> SparseRatings:
    return SparseRatings(r.rows, r.cols, r.vals, r.shape)


@pytest.fixture(scope="module")
def small_data():
    ratings, _, _ = synthetic_lowrank(250, 180, k_true=8, nnz=8000, noise=0.3, seed=1)
    return train_test_split(ratings, 0.1, seed=2)


@pytest.mark.parametrize("widths", [WIDTHS, (8, 32, 128, 512)])
@pytest.mark.parametrize("lam_reg", [0.05, 0.3])
def test_two_sweeps_match_reference_from_its_initial_factors(small_data, lam_reg, widths):
    train, test = small_data
    ja = JALS(train, test, k=16, lam_reg=lam_reg, widths=widths)
    ta = ALS(_port(train), _port(test), k=16, lam_reg=lam_reg, widths=widths, device=CPU)
    js = ja.init(0)
    ts = als_state_from_numpy(u=js.u, v=js.v, step=int(js.step), device=CPU)
    for _ in range(2):
        js, ts = ja.sweep(js), ta.sweep(ts)
    assert ts.step == int(js.step) == 2
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), err_msg="v", **TOL)
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), err_msg="u", **TOL)
    assert ta.rmse(ts) == pytest.approx(ja.rmse(js), rel=1e-4)


def test_rating_counts_are_the_degrees(small_data):
    train, _ = small_data
    a = ALS(_port(train), k=4, widths=WIDTHS, device=CPU)
    np.testing.assert_array_equal(a.user_counts.numpy(), train.degrees(0).astype(np.float32))
    np.testing.assert_array_equal(a.item_counts.numpy(), train.degrees(1).astype(np.float32))


def test_bpmf_beats_or_matches_als(small_data):
    """Paper Sec 5.2: Gibbs reaches ALS's accuracy without tuning lambda."""
    train, test = _port(small_data[0]), _port(small_data[1])
    s = GibbsSampler(train, test, k=16, alpha=1.0 / 0.09, burn_in=8, widths=WIDTHS,
                     device=CPU)
    st_g = s.run(30, seed=0)
    als = ALS(train, test, k=16, lam_reg=0.3, widths=WIDTHS, device=CPU)
    st_a = als.run(12)
    assert np.isfinite(als.rmse(st_a))
    assert s.rmse(st_g) <= als.rmse(st_a) + 0.02, (s.rmse(st_g), als.rmse(st_a))


def test_quickstart_example_runs_on_the_cpu(capsys):
    """examples/quickstart_torch.py end to end with `--device cpu`: Gibbs at
    k = 32 and ALS on chembl_like print finite RMSEs, Gibbs within the
    gate above of ALS."""
    path = Path(__file__).resolve().parents[1] / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--device", "cpu"])
    out = capsys.readouterr().out
    gibbs = float(re.search(r"BPMF posterior-mean RMSE: (\S+)", out).group(1))
    als = float(re.search(r"ALS baseline RMSE: +(\S+)", out).group(1))
    assert np.isfinite(gibbs) and np.isfinite(als), out
    assert gibbs <= als + 0.02, (gibbs, als)
