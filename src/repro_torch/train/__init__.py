"""Training: data, AdamW, the microbatched step, checkpoints and the
elastic resize (port of ``repro/train``). The rank's step over a mesh is
``launch/train_mesh.py``."""

from repro_torch.train import checkpoint, elastic
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_update, init_adamw)
from repro_torch.train.train_step import (TrainState, choose_microbatches,
                                          init_train_state, make_train_step,
                                          train_state_specs)

__all__ = ["AdamWConfig", "AdamWState", "adamw_update", "init_adamw",
           "TrainState", "choose_microbatches", "init_train_state",
           "make_train_step", "train_state_specs", "DataConfig",
           "SyntheticLM", "checkpoint", "elastic"]
