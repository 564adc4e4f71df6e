"""The sampler: degree-bucketed plans, Normal-Wishart hyperpriors and the
single-device Gibbs sweep (the paper's Algorithm 1)."""
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

__all__ = [
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
