"""The port's optimisers and schedules (`repro/optim`): AdamW with
global-norm clipping for the LM, int8 gradient compression with error
feedback, and the schedules of the LM and the samplers."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    opt_state_from_numpy,
)
from repro_torch.optim.compress import (
    CompressState,
    compress_init,
    compressed_psum,
    int8_compress,
    int8_decompress,
)
from repro_torch.optim.schedule import cosine_schedule, sgld_step_schedule

__all__ = ["AdamWConfig", "AdamWState", "CompressState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "compress_init", "compressed_psum", "cosine_schedule",
           "int8_compress", "int8_decompress", "opt_state_from_numpy",
           "sgld_step_schedule"]
