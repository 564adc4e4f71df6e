"""PyTorch and CUDA port of the BPMF train-and-serve system.

`repro` (JAX) is the reference; this package runs the same main path on an
NVIDIA Hopper GPU: ratings -> degree-bucketed plans -> Gibbs sweeps ->
retained draws in a SampleStore -> PosteriorEnsemble -> streaming top-N.

It imports torch and numpy only, never jax and nothing of `repro`. Every
Pallas kernel on the path is a hand-written CUDA C++ kernel under `csrc/`,
built with nvcc at first use and bound with ctypes (`kernels/build.py`);
`kernels/ops.py` holds the wrappers and `kernels/ref.py` their plain
PyTorch versions, which run only for tensors on the CPU.

Entry points (`GibbsSampler`, `PosteriorEnsemble`, `TopNRecommender`) take
`device=` and default to "cuda"; without a card they raise unless the
caller asks for the CPU.
"""
