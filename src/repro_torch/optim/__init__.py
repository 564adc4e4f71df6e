"""The port's optimisers and schedules (`repro/optim`): AdamW with
global-norm clipping for the LM, and the schedules of the LM and the
samplers."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    opt_state_from_numpy,
)
from repro_torch.optim.schedule import cosine_schedule, sgld_step_schedule

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "cosine_schedule", "opt_state_from_numpy",
           "sgld_step_schedule"]
