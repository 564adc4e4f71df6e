"""The samplers: degree-bucketed plans, Normal-Wishart hyperpriors, the
single-device Gibbs sweep (the paper's Algorithm 1), the ALS baseline and
the minibatch SGLD samplers, single-device and distributed."""
from repro_torch.core.als import ALS, ALSState
from repro_torch.core.buckets import BucketPlan, plan_buckets, workload_model
from repro_torch.core.gibbs import (
    ENGINES,
    BPMFState,
    GibbsSampler,
    SweepNoise,
    state_from_numpy,
    state_from_sample,
)
from repro_torch.core.hyper import (
    HyperParams,
    NWPrior,
    WishartNoise,
    default_prior,
    sample_normal_wishart,
)
from repro_torch.core.sgld import DistributedSGLD, SGLDNoise, SGLDSampler

__all__ = [
    "ALS",
    "ALSState",
    "DistributedSGLD",
    "SGLDNoise",
    "SGLDSampler",
    "BucketPlan",
    "plan_buckets",
    "workload_model",
    "ENGINES",
    "BPMFState",
    "GibbsSampler",
    "SweepNoise",
    "state_from_numpy",
    "state_from_sample",
    "HyperParams",
    "NWPrior",
    "WishartNoise",
    "default_prior",
    "sample_normal_wishart",
]
