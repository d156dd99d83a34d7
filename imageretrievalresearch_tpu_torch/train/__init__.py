"""Training: optimizer and schedule, the loss-combination steps, the
Trainer (one card) and the LR range test (``train.lr_finder``)."""

from imageretrievalresearch_tpu_torch.train.lr_finder import lr_find
from imageretrievalresearch_tpu_torch.train.steps import (
    build_classifier_eval_step,
    build_classifier_train_step,
    build_eval_step,
    build_train_step,
)
from imageretrievalresearch_tpu_torch.train.train_state import (
    TrainState,
    make_optimizer,
    multistep_lr,
)
from imageretrievalresearch_tpu_torch.train.trainer import (
    EarlyStopping,
    Trainer,
)

__all__ = [
    "TrainState",
    "make_optimizer",
    "multistep_lr",
    "build_train_step",
    "build_eval_step",
    "build_classifier_train_step",
    "build_classifier_eval_step",
    "EarlyStopping",
    "Trainer",
    "lr_find",
]
