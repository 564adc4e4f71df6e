"""Host-side sparse rating-matrix containers.

All planning (bucketing, partitioning, reordering) happens on the host in
numpy; only the padded dense plan arrays ever reach a device. This mirrors the
paper's setup where the sparsity structure of R is analysed once up front
(cache reordering, 2-D distribution) and the sampler then runs on a fixed
layout.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SparseRatings:
    """COO ratings with both orientations derivable.

    rows  -- user index per rating   (nnz,) int32
    cols  -- item index per rating   (nnz,) int32
    vals  -- rating value            (nnz,) float32
    shape -- (n_users, n_items)
    """

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def validate(self) -> None:
        assert self.rows.shape == self.cols.shape == self.vals.shape
        assert self.rows.min(initial=0) >= 0 and (
            self.nnz == 0 or self.rows.max() < self.shape[0]
        )
        assert self.cols.min(initial=0) >= 0 and (
            self.nnz == 0 or self.cols.max() < self.shape[1]
        )

    def transpose(self) -> "SparseRatings":
        return SparseRatings(
            rows=self.cols, cols=self.rows, vals=self.vals, shape=self.shape[::-1]
        )

    def csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Row-major CSR (indptr, indices, values)."""
        return csr_from_coo(self.rows, self.cols, self.vals, self.shape[0])

    def degrees(self, axis: int = 0) -> np.ndarray:
        idx = self.rows if axis == 0 else self.cols
        n = self.shape[axis]
        return np.bincount(idx, minlength=n).astype(np.int64)

    def mean(self) -> float:
        return float(self.vals.mean()) if self.nnz else 0.0

    def centered(self) -> "SparseRatings":
        """Global-mean-centred copy (standard BPMF preprocessing)."""
        return SparseRatings(
            rows=self.rows,
            cols=self.cols,
            vals=(self.vals - self.mean()).astype(np.float32),
            shape=self.shape,
        )


def csr_from_coo(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_rows: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    order = np.argsort(rows, kind="stable")
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.add.at(indptr, rows_s + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, cols_s.astype(np.int32), vals_s.astype(np.float32)
