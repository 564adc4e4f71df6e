"""The work that BPMF's inputs need, counted from their sizes.

These count what the algorithm must do for the inputs, not what an
implementation does: every rating once, every factor row's system once,
each input byte read once and each output byte written once. Padded plan
slots, recomputation and scratch are the implementation's, so a change to
the program never changes its own yardstick. A multiply-add counts as two
operations; a symmetric K x K result counts its K(K + 1) / 2 distinct
entries.

Written for the benchmark; where `src/repro_torch/kernels/ops.py` at
commit 3b55c50 counts the same kernel (`syrk_flops`, `_flops_*`), it counts
every padded slot of the plan instead.
"""
from __future__ import annotations

F32 = 4


def tri(k: int) -> int:
    """Distinct entries of a symmetric k x k matrix."""
    return k * (k + 1) // 2


def stats_flops(nnz: int, k: int) -> float:
    """One half-sweep's rating statistics: sum u u^T (K(K + 1) / 2
    multiply-adds a rating) and sum r u (K)."""
    return 2.0 * nnz * (tri(k) + k)


def stats_bytes(nnz: int, n_counterparts: int, n_segments: int, k: int) -> float:
    """One half-sweep's statistics: each rating's index and value read
    once, the counterpart factors read once, each rated target's
    symmetric system and right-hand side written once."""
    return (nnz * 2 * F32 + n_counterparts * k * F32
            + n_segments * (tri(k) + k) * F32)


def solve_flops(n_systems: int, k: int) -> float:
    """Cholesky (K^3 / 3) and two triangular solves (K^2 each), a system."""
    return n_systems * (k ** 3 / 3 + 2 * k * k)


def sweep_flops(m: int, n: int, nnz: int, n_test: int, k: int) -> float:
    """One Gibbs sweep: both sides' statistics, each system assembled
    (prior plus alpha times the statistics, K(K + 1) / 2 multiply-adds)
    and solved, both hyper draws' scatter matrices (K(K + 1) / 2
    multiply-adds a factor row), and the test prediction (K a rating)."""
    return (2 * stats_flops(nnz, k) + solve_flops(m + n, k)
            + 2.0 * (m + n) * tri(k) * 2 + 2.0 * n_test * k)


def topn_flops(b: int, n: int, width: int) -> float:
    """Scoring b users against n items at width S K."""
    return 2.0 * b * n * width


def topn_bytes(b: int, n: int, width: int, topk: int) -> float:
    """The users' scoring rows and the items' read once, each list's
    scores and ids written once."""
    return (b + n) * width * F32 + b * topk * 2 * F32
