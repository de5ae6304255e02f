"""The judge classifier of the Moving MNIST disentanglement probes.

Counterpart of ``ode_rl_tpu/eval_models/mmnist_judge.py``: a small
supervised classifier that scores the decodes of latent swaps on

* content: which sprite is drawn, read position-invariantly through a
  global average pool over the map and the mean over time;
* motion: the canvas quadrant of the digit at the first and the last
  frame (labels from the generator's trajectory), read from the flattened
  feature map of that frame.

The three stride-2 convs run NCHW through ``F.conv2d`` (``nn/conv_stacks
.Conv``) and hand back NHWC, so ``fc_m`` reads its frame's (8, 8, 64) map
flattened in flax's NHWC order and its kernel converts by name.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.data.sprites import DIGIT_SIZE
from ode_rl_torch.nn.conv_stacks import Conv
from ode_rl_torch.nn.dense import Dense


def quadrant_labels(positions: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, D, T, 2) int top-left positions -> (start_quad, end_quad),
    each (B,) int64, for the first digit: the canvas quadrant of its
    centre at the first and the last frame, 2 * (y >= 32) + (x >= 32)."""
    center = positions[:, 0].float() + DIGIT_SIZE / 2.0
    quad = lambda p: (2 * (p[:, 0] >= 32).long() + (p[:, 1] >= 32).long())
    return quad(center[:, 0]), quad(center[:, -1])


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(-F.log_softmax(logits.float(), dim=-1)[
        torch.arange(labels.shape[0], device=labels.device), labels])


def _acc(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((logits.argmax(-1) == labels).float())


class MMNISTJudge(nn.Module):
    def __init__(self, n_sprites: int = 16, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(stride=2, padding=1, dtype=dtype, generator=generator)
        self.c0 = Conv(1, 32, 3, **kw)
        self.c1 = Conv(32, 64, 3, **kw)
        self.c2 = Conv(64, 64, 3, **kw)
        self.fc_c = Dense(64, 128, generator=generator)
        self.head_sprite = Dense(128, n_sprites, generator=generator)
        self.fc_m = Dense(8 * 8 * 64, 128, generator=generator)
        self.head_q0 = Dense(128, 4, generator=generator)
        self.head_q1 = Dense(128, 4, generator=generator)
        self.dtype = dtype

    def forward(self, video: torch.Tensor) -> Dict[str, torch.Tensor]:
        """video (B, T, 64, 64, 1) in [0, 1] -> logits {'sprite', 'q0',
        'q1'}."""
        b, t = video.shape[:2]
        x = video.reshape(b * t, *video.shape[2:]).to(self.dtype)
        h = torch.relu(self.c0(x))
        h = torch.relu(self.c1(h))
        h = torch.relu(self.c2(h)).reshape(b, t, 8, 8, 64)   # NHWC
        gap = h.mean(dim=(2, 3)).mean(dim=1)
        sprite = self.head_sprite(torch.relu(self.fc_c(gap)))
        q0 = self.head_q0(torch.relu(self.fc_m(h[:, 0].reshape(b, -1))))
        q1 = self.head_q1(torch.relu(self.fc_m(h[:, -1].reshape(b, -1))))
        return {"sprite": sprite, "q0": q0, "q1": q1}

    def loss(self, video: torch.Tensor, sprite_lbl: torch.Tensor,
             q0_lbl: torch.Tensor, q1_lbl: torch.Tensor):
        """The summed cross-entropies of the three heads, and (loss,
        per-head accuracies) as metrics."""
        logits = self(video)
        loss = (_xent(logits["sprite"], sprite_lbl)
                + _xent(logits["q0"], q0_lbl) + _xent(logits["q1"], q1_lbl))
        metrics = {"loss": loss,
                   "acc_sprite": _acc(logits["sprite"], sprite_lbl),
                   "acc_q0": _acc(logits["q0"], q0_lbl),
                   "acc_q1": _acc(logits["q1"], q1_lbl)}
        return loss, metrics
