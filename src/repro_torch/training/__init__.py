"""Training substrate: AdamW, LR schedules, losses, train step, checkpoints.

Port of ``repro/training``; exports the reference's names."""

from repro_torch.training.optimizer import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
)
from repro_torch.training.losses import lm_loss
from repro_torch.training.train_loop import make_train_step, TrainState
from repro_torch.training.checkpoint import save_checkpoint, load_checkpoint

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "lm_loss",
    "make_train_step",
    "TrainState",
    "save_checkpoint",
    "load_checkpoint",
]
