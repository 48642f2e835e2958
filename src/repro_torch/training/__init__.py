from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.data import DataConfig, MarkovTextStream, batch_for
from repro_torch.training.grpo import group_advantages, grpo_loss, make_grpo_step
from repro_torch.training.optimizer import AdamWConfig, AdamWState, adamw_update, init_adamw
from repro_torch.training.train_step import (
    TrainState,
    init_train_state,
    make_grad_accum_train_step,
    make_train_step,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "DataConfig",
    "MarkovTextStream",
    "TrainState",
    "adamw_update",
    "batch_for",
    "group_advantages",
    "grpo_loss",
    "init_adamw",
    "init_train_state",
    "load_checkpoint",
    "make_grad_accum_train_step",
    "make_grpo_step",
    "make_train_step",
    "save_checkpoint",
]
