"""Training on the card: data, AdamW, the microbatched step and
checkpoints (port of ``repro/train``; the multi-device ``elastic`` module
and ``train_state_specs`` wait for the multi-device plane)."""

from repro_torch.train import checkpoint
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_update, init_adamw)
from repro_torch.train.train_step import (TrainState, choose_microbatches,
                                          init_train_state, make_train_step)

__all__ = ["AdamWConfig", "AdamWState", "adamw_update", "init_adamw",
           "TrainState", "choose_microbatches", "init_train_state",
           "make_train_step", "DataConfig", "SyntheticLM", "checkpoint"]
