"""The Sprites judge classifier.

Counterpart of ``ode_rl_tpu/sprite/classifier.py``: an LSTM over the
motion latents z_1..z_T (nn/dense.py's ``LSTM``, flax's
OptimizedLSTMCell under ``z_lstm.cell``) whose last output feeds the
action head, and an MLP on the content latent f feeding the attribute
head. It scores disentanglement: the action should be readable from z
alone and the attributes from f alone.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.nn.dense import LSTM, Dense


class SpriteJudge(nn.Module):
    def __init__(self, z_dim: int, f_dim: int, n_actions: int = 4,
                 n_attrs: int = 6, hidden: int = 128, *,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(generator=generator)
        self.n_actions, self.n_attrs = n_actions, n_attrs
        self.z_lstm = LSTM(z_dim, hidden, **kw)
        self.action_head = Dense(hidden, n_actions, **kw)
        self.attr_h = Dense(f_dim, hidden, **kw)
        self.attr_head = Dense(hidden, n_attrs, **kw)

    def forward(self, z_seq: torch.Tensor, f: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """z_seq (B, T, z_dim), f (B, f_dim) -> (action logits, attribute
        logits)."""
        action_logits = self.action_head(self.z_lstm(z_seq)[:, -1])
        attr_logits = self.attr_head(torch.relu(self.attr_h(f)))
        return action_logits, attr_logits

    def loss(self, z_seq: torch.Tensor, f: torch.Tensor,
             actions: torch.Tensor, attrs: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        a_log, at_log = self(z_seq, f)
        xent = lambda logits, labels, n: -torch.mean(torch.sum(
            F.one_hot(labels.long(), n) * F.log_softmax(logits.float(), -1),
            -1))
        acc = lambda logits, labels: torch.mean(
            (logits.argmax(-1) == labels).float())
        a_loss = xent(a_log, actions, self.n_actions)
        at_loss = xent(at_log, attrs, self.n_attrs)
        metrics = {"action_loss": a_loss, "attr_loss": at_loss,
                   "action_acc": acc(a_log, actions),
                   "attr_acc": acc(at_log, attrs)}
        return a_loss + at_loss, metrics
