"""Learner runtime (the synchronous FedAvg round's learner)."""

from metisfl_tpu_torch.learner.learner import (
    ControllerProxy,
    Learner,
    check_train_task,
)

__all__ = ["Learner", "ControllerProxy", "check_train_task"]
