"""Optimizers and LR schedules (counterpart of vcrnet_tpu/train/optim.py).

Adam(lr, weight_decay=1e-4, eps=1e-8) or SGD(lr*100, momentum,
weight_decay): torch's weight decay adds L2 to the gradient before the
moments, which is the optax chain ``add_decayed_weights`` ->
``scale_by_adam`` / ``trace`` of the JAX package. ReduceLROnPlateau
(min, factor 0.1, threshold 1e-6 relative) is stepped on the best test
loss with an early stop at lr <= 1.1e-6; MultiStepLR([75, 150, 200], 0.1).
The schedulers return the new rate and ``set_lr`` writes it into the
optimizer, as the JAX package does per epoch.
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.config import Config


def initial_lr(cfg: Config) -> float:
    return cfg.lr * 100.0 if cfg.use_sgd else cfg.lr


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    if cfg.use_sgd:
        return torch.optim.SGD(params, lr=initial_lr(cfg), momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay)
    return torch.optim.Adam(params, lr=initial_lr(cfg), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


class ReduceLROnPlateau:
    """torch ReduceLROnPlateau, mode='min', threshold_mode='rel'."""

    def __init__(self, lr: float, factor=0.1, patience=10, threshold=1e-6):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr *= self.factor
            self.num_bad_epochs = 0
        return self.lr


class MultiStepLR:
    """torch MultiStepLR: lr * gamma^(milestones passed)."""

    def __init__(self, lr: float, milestones=(75, 150, 200), gamma=0.1):
        self.base_lr = lr
        self.milestones = sorted(milestones)
        self.gamma = gamma
        self.epoch = 0
        self.lr = lr

    def step(self, _metric: float | None = None) -> float:
        self.epoch += 1
        passed = sum(1 for m in self.milestones if self.epoch >= m)
        self.lr = self.base_lr * self.gamma ** passed
        return self.lr


EARLY_STOP_LR = 1.1e-6
