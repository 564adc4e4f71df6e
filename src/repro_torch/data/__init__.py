from repro_torch.data.sparse import SparseRatings, csr_from_coo
from repro_torch.data.datasets import (
    synthetic_lowrank,
    chembl_like,
    movielens_like,
    train_test_split,
)

__all__ = [
    "SparseRatings",
    "csr_from_coo",
    "synthetic_lowrank",
    "chembl_like",
    "movielens_like",
    "train_test_split",
]
