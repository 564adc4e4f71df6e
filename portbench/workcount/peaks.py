"""Published peaks of one NVIDIA H100 80GB HBM3 (SXM), dense, without
sparsity, at its full 700 W power limit (NVIDIA's data sheet).

Copied as numbers from `src/repro_torch/launch/mesh.py` at commit 3b55c50
(HBM_BYTES_PER_S, FP32_FLOPS, BF16_TENSOR_FLOPS). A card set below 700 W
runs slower under load: a run prints the card's power limit beside its
numbers. None of the kernels measured here runs on the tensor cores, so
every share is taken against the float32 rate outside them.
"""
CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700.0
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card needs for `flops` float32 operations and
    `nbytes` of device-memory traffic: the larger of the two bounds."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
