"""The card's roofline constants, the counterpart of `repro/launch/mesh.py`'s.

The port runs on one NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit.
The rates are the published peaks of NVIDIA's data sheet, dense, without
sparsity; a card set below 700 W runs slower under load, so a roofline
share is stated beside the card's name and power limit
(`nvidia-smi --query-gpu=name,power.limit`). `launch/cost.py::roofline_terms`
and `chip_smoke.py`'s bounds read them.

The JAX module's mesh helpers (`make_production_mesh`,
`serving_host_devices`, `make_host_mesh`) wait for a host with several
cards (ROADMAP.md, queue 1 item 7); NVLINK_BYTES_PER_S is here for that
slice and for the dry-run's link term.
"""
from __future__ import annotations

#: the card the constants describe, and the power limit they assume
CARD = "NVIDIA H100 80GB HBM3"
CARD_POWER_LIMIT_W = 700.0
#: device memory: bytes, and bytes a second
HBM_BYTES = 80e9
HBM_BYTES_PER_S = 3.35e12
#: float32 operations a second outside the tensor cores
FP32_FLOPS = 67e12
#: bf16 (and fp16) tensor-core operations a second
BF16_TENSOR_FLOPS = 989e12
#: NVLink to the other cards of the host, each way (900 GB/s both ways)
NVLINK_BYTES_PER_S = 450e9
