"""The fault-tolerant training loop (`repro/runtime`)."""
from repro_torch.runtime.trainer import SimulatedFailure, Trainer, TrainerConfig

__all__ = ["SimulatedFailure", "Trainer", "TrainerConfig"]
