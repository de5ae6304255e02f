"""Plateau LR and early stopping.

Counterpart of ``ReduceLROnPlateau``, ``EarlyStopping`` and
``set_lr_scale`` in ``ode_rl_tpu/train/schedulers.py``: host-side state
machines fed one validation metric an epoch, with JAX's comparisons (an
improvement is ``metric < best - 1e-12`` for the plateau, ``metric < best
- min_delta`` for early stopping). JAX keeps the plateau scale in the
optax chain, a ``scale(step_size)`` after Adam or Adamax; here it is the
param groups' lr, ``cfg.lr * scale``, with the scale beside it in each
group as ``lr_scale``; the optimizer's ``state_dict`` carries both
through a checkpoint and a resume as JAX's ``opt_state`` carries its
scale. The Vid-ODE GAN loop's per-epoch decay
is ``train/gan.py::make_gan_lr_schedule``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


class ReduceLROnPlateau:
    """The lr scale: multiplied by ``factor`` (not below ``min_scale``)
    after more than ``patience`` epochs without improvement."""

    def __init__(self, factor: float = 0.5, patience: int = 4,
                 min_scale: float = 1e-3):
        self.factor, self.patience, self.min_scale = (factor, patience,
                                                      min_scale)
        self.best = math.inf
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best - 1e-12:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad_epochs = 0
        return self.scale


class EarlyStopping:
    """True from the epoch the metric has gone ``patience`` epochs
    without improving by more than ``min_delta``."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0):
        self.patience, self.min_delta = patience, min_delta
        self.best: Optional[float] = None
        self.counter = 0
        self.should_stop = False

    def step(self, metric: float) -> bool:
        if self.best is None or metric < self.best - self.min_delta:
            self.best = metric
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop


def set_lr_scale(optimizer: torch.optim.Optimizer, base_lr: float,
                 scale: float) -> None:
    """Every param group's lr to ``base_lr * scale``, and its
    ``lr_scale`` to ``scale``."""
    for group in optimizer.param_groups:
        group["lr"] = base_lr * scale
        group["lr_scale"] = scale


def lr_scale(optimizer_state: dict) -> float:
    """The plateau scale of an optimizer's ``state_dict`` (1.0 until the
    plateau moves it)."""
    return float(optimizer_state["param_groups"][0].get("lr_scale", 1.0))
