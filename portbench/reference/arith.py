"""The precisions a reference computes in.

  float64  the reference itself: float64 storage and products
  tf32     float32 storage; every operand of a product (the matrix
           products and the rating statistics' outer products) rounded to
           TF32 first (10 explicit mantissa bits, round to nearest even),
           sums in float32: what a tensor-core TF32 product does, the same
           on every device
  bf16     the same with operands rounded to bfloat16 (7 mantissa bits)

The last two are the controls: the step below the float32 that the
configurations state.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float64", "tf32", "bf16")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to the nearest TF32 value, ties to even."""
    bits = x.contiguous().view(torch.int32)
    low = 13   # float32 keeps 23 mantissa bits, TF32 10
    lsb = (bits >> low) & 1
    rounded = (bits + ((1 << (low - 1)) - 1) + lsb) & ~((1 << low) - 1)
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


class Arith:
    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """x as an operand of a product in this precision."""
        x = x.to(self.dtype)
        if self.precision == "tf32":
            return to_tf32(x)
        if self.precision == "bf16":
            return x.to(torch.bfloat16).to(torch.float32)
        return x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.operand(a) @ self.operand(b)


@contextlib.contextmanager
def no_tf32():
    """A context in which float32 products are IEEE float32 on the card."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
