"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device an entry point runs on; "cuda" is the default.

    Raises when a CUDA device is asked for and none is present: the port
    never drops to the CPU quietly, the caller asks for it with
    device="cpu". On a CUDA device fp32 stays IEEE fp32: TF32 is switched
    off for matrix products and for cuDNN, so the sweep's fp32 products
    keep the reference's tolerances (rtol 1e-4).
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
