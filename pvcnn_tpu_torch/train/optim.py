"""Optimizer and learning-rate schedules (counterpart of
pvcnn_tpu/train/optim.py: Adam, CosineAnnealingLR, StepLR, MultiStepLR).

`Adam` is torch.optim.Adam: L2 weight decay folded into the gradient before
the moments (not AdamW's decoupled decay), bias correction, eps outside the
square root; the JAX package pins its optax chain to these semantics. The
schedules are epoch -> lr callables bound to the optimizer's base lr, set
once per epoch with `set_learning_rate`, as the JAX trainer does.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["Adam", "CosineAnnealingLR", "MultiStepLR", "StepLR",
           "set_learning_rate"]


def Adam(params, lr: float = 1e-3, weight_decay: float = 0.0,
         eps: float = 1e-8) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay, eps=eps)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


class _Scheduler:
    def __init__(self, base_lr: float | None = None):
        self.base_lr = base_lr

    def bind(self, base_lr: float):
        if self.base_lr is None:
            self.base_lr = base_lr
        return self

    def __call__(self, epoch: int) -> float:
        raise NotImplementedError


class CosineAnnealingLR(_Scheduler):
    def __init__(self, t_max: int, eta_min: float = 0.0,
                 base_lr: float | None = None):
        super().__init__(base_lr)
        self.t_max = t_max
        self.eta_min = eta_min

    def __call__(self, epoch: int) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * epoch / self.t_max)) / 2


class StepLR(_Scheduler):
    def __init__(self, step_size: int, gamma: float = 0.1,
                 base_lr: float | None = None):
        super().__init__(base_lr)
        self.step_size = step_size
        self.gamma = gamma

    def __call__(self, epoch: int) -> float:
        return self.base_lr * (self.gamma ** (epoch // self.step_size))


class MultiStepLR(_Scheduler):
    def __init__(self, milestones: Sequence[int], gamma: float = 0.1,
                 base_lr: float | None = None):
        super().__init__(base_lr)
        self.milestones = sorted(milestones)
        self.gamma = gamma

    def __call__(self, epoch: int) -> float:
        passed = sum(1 for m in self.milestones if m <= epoch)
        return self.base_lr * (self.gamma ** passed)
