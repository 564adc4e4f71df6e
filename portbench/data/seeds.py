"""Independent random streams from one run seed.

Each purpose ("ratings", "init", "noise", ...) gets its own
`torch.Generator`, seeded from the run seed and the purpose's name through
numpy's SeedSequence, so adding a stream never shifts another. Any whole
number is a seed: it is taken modulo 2**64.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch


def stream_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for `purpose`'s stream under the run seed."""
    ss = np.random.SeedSequence([int(seed) % 2**64, zlib.crc32(purpose.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, purpose: str, device) -> torch.Generator:
    """A torch.Generator on `device` for `purpose` under the run seed."""
    return torch.Generator(device=device).manual_seed(stream_seed(seed, purpose))


def host_rng(seed: int, purpose: str) -> np.random.Generator:
    """A numpy Generator on the host for `purpose` under the run seed."""
    return np.random.default_rng(stream_seed(seed, purpose))
