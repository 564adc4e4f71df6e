"""Schedules of the port's samplers (`repro/optim`); the LM optimiser is
not ported yet (ROADMAP.md, queue 1 item 12)."""
from repro_torch.optim.schedule import cosine_schedule, sgld_step_schedule

__all__ = ["cosine_schedule", "sgld_step_schedule"]
