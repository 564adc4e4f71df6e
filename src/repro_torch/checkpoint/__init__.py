from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.checkpoint.samples import (
    SAMPLE_KEYS,
    RetainedSample,
    SampleStore,
    as_retained_sample,
)

__all__ = ["CheckpointStore", "SAMPLE_KEYS", "RetainedSample", "SampleStore",
           "as_retained_sample"]
