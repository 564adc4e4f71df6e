"""The frozen copies: the rating generator against the degree statistics
of the one it was copied from, the idle-share arithmetic on a made-up
trace, the card's published peaks and the work counts."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import tiny  # noqa: F401  (puts the repo and src on the path)

from portbench.data import ratings as gen
from portbench.harness import spec
from portbench.harness import trace as tracing
from portbench.workcount import bpmf, peaks


def _stats(rows, cols, shape):
    du = np.bincount(rows, minlength=shape[0])
    di = np.bincount(cols, minlength=shape[1])
    return {"nnz": len(rows), "user_mean": du.mean(), "user_p99": np.percentile(du, 99),
            "user_max": du.max(), "users_none": int((du == 0).sum()),
            "item_max": di.max(), "items_none": int((di == 0).sum())}


CONFIGS = {
    # (config data, the original generator, its scale)
    "chembl": (spec.load_json(spec.BENCH / "configs" / "chembl-k64.json")["data"],
               "chembl_like", 1.0),
    "ml20m_0.05": (dict(n_users=6_924, n_items=1_363, nnz=1_000_000, k_true=16, noise=0.5,
                        item_exponent=1.0, user_exponent=0.6, clip=[-2.5, 2.5],
                        test_frac=0.1, structure_seed=0), "movielens_like", 0.05),
}


@pytest.mark.parametrize("name", CONFIGS)
def test_generator_keeps_the_degree_statistics(name):
    """The original's statistics, but for two departures: the pattern holds
    exactly `nnz` pairs, where the original may stop a few short; and with
    `every_user_rated` no user is left without a rating, so only those
    whose every rating fell in the test split have none in training, and
    the pairs that rate them are taken from the heaviest users."""
    from repro_torch.data import datasets

    data, original, scale = CONFIGS[name]
    split = gen.ratings({"data": data}, 12345, "cpu")
    tr = split.train
    got = _stats(tr.rows.numpy(), tr.cols.numpy(), tr.shape)
    r, _, _ = getattr(datasets, original)(scale, seed=0)
    tr0, _ = datasets.train_test_split(r, 0.1, seed=0)
    want = _stats(tr0.rows, tr0.cols, tr0.shape)
    n_test = int(data["nnz"] * data["test_frac"])
    assert (got["nnz"], split.test.nnz) == (data["nnz"] - n_test, n_test)
    assert want["nnz"] <= got["nnz"] <= 1.005 * want["nnz"]
    if data.get("every_user_rated"):
        full = np.bincount(np.concatenate([tr.rows.numpy(), split.test.rows.numpy()]),
                           minlength=tr.shape[0])
        assert full.min() == 1
        # a user's ratings all fall in the test split with about 0.1^degree
        assert got["users_none"] == pytest.approx(float((0.1 ** full).sum()), rel=0.05)
        assert got["user_p99"] == pytest.approx(want["user_p99"], rel=0.1)
        assert 0.6 * want["user_max"] <= got["user_max"] <= want["user_max"]
        assert want["item_max"] <= got["item_max"] <= 1.15 * want["item_max"]
    else:
        assert got["user_p99"] == pytest.approx(want["user_p99"], rel=0.05)
        assert got["user_max"] == pytest.approx(want["user_max"], rel=0.15)
        assert got["item_max"] == pytest.approx(want["item_max"], rel=0.05)
        assert got["users_none"] == pytest.approx(want["users_none"], rel=0.02, abs=2)
    vals = tr.vals.double()
    assert vals.std().item() == pytest.approx(float(tr0.vals.std()), rel=0.05)
    if data["clip"]:
        assert vals.abs().max().item() <= 2.5


def test_seed_relabels_the_same_pattern():
    data = CONFIGS["ml20m_0.05"][0]
    a = gen.ratings({"data": data}, 1, "cpu").train
    b = gen.ratings({"data": data}, 2, "cpu").train
    for axis in (0, 1):
        assert torch.equal(torch.sort(a.degrees(axis)).values, torch.sort(b.degrees(axis)).values)
    assert not torch.equal(a.degrees(0), b.degrees(0))
    c = gen.ratings({"data": data}, 1, "cpu").train
    assert torch.equal(a.rows, c.rows) and torch.equal(a.vals, c.vals)


def test_union_and_idle_share_on_a_made_up_trace():
    us = 1.0
    events = [
        {"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW, "ts": 100.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "void ns::k_a<64>(float*)", "ts": 90.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 105.0, "dur": 10.0},  # overlaps k_a
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 150.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 190.0, "dur": 30.0},  # past the end
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 115.0, "dur": 40.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 120.0, "dur": 30.0},
        {"ph": "X", "cat": "cpu_op", "name": "ProfilerStep#1", "ts": 50.0, "dur": 300.0},
    ]
    t = tracing.from_events(events, {"sweeps": 2})
    assert t.window_s == pytest.approx(100 * us * 1e-6)
    # busy: [100, 115) + [150, 160) + [190, 200) = 35 us of 100
    assert t.busy_s == pytest.approx(35e-6)
    assert t.idle_share == pytest.approx(0.65)
    assert t.kernel_s(["k_a"]) == pytest.approx(10e-6)
    assert t.kernel_s(["k_b"]) == pytest.approx(20e-6)
    assert tracing.kernel_name("void ns::k_a<64>(float*)") == "k_a"
    assert tracing.kernel_name("void (anonymous namespace)::gather_syrk_rows_kernel<64, float, "
                               "double>(int const*, float*)") == "gather_syrk_rows_kernel"
    assert tracing.kernel_name("(anonymous namespace)::topn_score_kernel(float const*, int)"
                               ) == "topn_score_kernel"
    assert tracing.kernel_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"
    gaps = dict(t.idle_gaps())
    # [115, 150) middle 132.5: inside the runtime call; [160, 190) middle 175: nothing
    assert gaps == {"cudaMemcpyAsync": pytest.approx(35e-6), "host code outside any recorded op": pytest.approx(30e-6)}
    assert t.device_ops()[0][0] == "k_b"
    assert t.counts == {"sweeps": 2}


def test_peaks_and_work_counts():
    assert (peaks.HBM_BYTES_PER_S, peaks.FP32_FLOPS, peaks.BF16_TENSOR_FLOPS) == (3.35e12, 67e12,
                                                                                  989e12)
    assert peaks.least_s(67e12, 0) == 1.0 and peaks.least_s(0, 3.35e12) == 1.0
    # a rating's statistics at K = 64: 2080 + 64 multiply-adds
    assert bpmf.stats_flops(1, 64) == 2 * (2080 + 64)
    # the ml20m sweep's statistics: 154 GFLOP (18.0 M ratings, both sides)
    assert 2 * bpmf.stats_flops(18_000_000, 64) == pytest.approx(154e9, rel=0.01)
    # a top-N batch at ml20m: 57.2 GFLOP
    assert bpmf.topn_flops(4096, 27_278, 256) == pytest.approx(57.2e9, rel=0.001)
