"""Training (port of ``train/``): the state and optimizer, the KD train and
eval steps, torch-native checkpoints and the ``Trainer``."""

from .state import AdamW, TrainState, lr_at, make_train_state
from .step import make_eval_step, make_train_step
from .trainer import Trainer

__all__ = [
    "AdamW",
    "TrainState",
    "Trainer",
    "lr_at",
    "make_eval_step",
    "make_train_state",
    "make_train_step",
]
