"""Learning-rate schedules (counterpart of bigdl_tpu/optim/schedule.py).
A schedule runs on the host each iteration; the trainer hands the
resulting scalar to the update. Only `Default` is ported so far."""

from __future__ import annotations

from typing import Dict


class LearningRateSchedule:
    """Computes the current LR from the optim state dict. Keys used:
    `neval` (iteration, 0-based), `epoch` (0-based)."""

    def __call__(self, base_lr: float, state: Dict) -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """Torch default: lr / (1 + neval * lr_decay)."""

    def __init__(self, lr_decay: float = 0.0):
        self.lr_decay = lr_decay

    def __call__(self, base_lr, state):
        return base_lr / (1 + state.get("neval", 0) * self.lr_decay)
