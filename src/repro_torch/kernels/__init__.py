"""Hand-written CUDA kernels for the BPMF and LM hot spots and their wrappers.

  csrc/gather_syrk_seg.cu  fused gather -> syrk -> segment reduce (engine "fused"),
                           and its store into the sweep's posterior systems
  csrc/masked_syrk.cu      syrk over a pre-gathered block (engine "kernel")
  csrc/chol_solve.cu       batched Cholesky solve and sample (engines "kernel", "fused")
  csrc/topn.cu             streaming top-k of U V^T (serving)
  csrc/flash_attention.cu  causal, windowed, soft-capped attention with an
                           online softmax (the LM's long-context forward)

  build.py  nvcc at first use, ctypes binding
  ops.py    wrappers: padding, checks, launch counters
  ref.py    plain PyTorch versions, run for CPU tensors and held against
            the kernels on the card
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
