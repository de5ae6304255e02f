"""A video classifier over world-model features (the CATER task head).

Counterpart of ``ode_rl_tpu/wm/classifier.py``: a GRU (nn/dense.py's
``GRU``, the counterpart of JAX's ``_GRU``) over (B, T, F) posterior
features, its last hidden state through a Dense ``head`` to the class
logits; the multilabel (or softmax) loss; the ranked mAP, the top-k
accuracy and the reference's threshold precision. JAX sorts stably
(``jnp.argsort(-scores)``) and ``lax.top_k`` puts the lower index first
among ties, so both take a stable sort of the negated scores here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.nn.dense import GRU, Dense


class FeatureClassifier(nn.Module):
    def __init__(self, feat_dim: int, n_classes: int, hidden: int = 256,
                 multilabel: bool = True, *, generator: torch.Generator):
        super().__init__()
        self.multilabel = multilabel
        self.gru = GRU(feat_dim, hidden, generator=generator)
        self.head = Dense(hidden, n_classes, generator=generator)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, T, F) -> (B, n_classes) logits."""
        _, h_last = self.gru(feats)
        return self.head(h_last)

    def loss(self, feats: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict]:
        logits = self(feats).float()
        labels = labels.float()
        if self.multilabel:
            loss = multilabel_bce(logits, labels)
        else:
            loss = -torch.mean(torch.sum(
                labels * torch.log_softmax(logits, -1), dim=-1))
        return loss, {"loss": loss,
                      "mAP": mean_average_precision(logits, labels),
                      "top5": top_k_accuracy(logits, labels, 5)}


def multilabel_bce(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    return -torch.mean(labels * F.logsigmoid(logits)
                       + (1 - labels) * F.logsigmoid(-logits))


def reference_map_precision(logits: torch.Tensor, labels: torch.Tensor,
                            from_logits: bool = True) -> torch.Tensor:
    """The reference's 'mAP': per-class precision at the 0.5 threshold,
    TP / (TP + FP + 1e-6), averaged over classes."""
    p = torch.sigmoid(logits) if from_logits else logits
    pred = p > 0.5
    y = labels.float()
    tp = ((y == 1.0) & pred).sum(0).float()
    fp = ((y == 0.0) & pred).sum(0).float()
    return torch.mean(tp / (tp + fp + 1e-6))


def mean_average_precision(logits: torch.Tensor, labels: torch.Tensor
                           ) -> torch.Tensor:
    """The mean over classes with a positive of the ranked average
    precision."""
    b = logits.shape[0]
    y = labels.float()
    order = torch.argsort(-logits.float(), dim=0, stable=True)
    y_sorted = torch.gather(y, 0, order)
    rank = torch.arange(1, b + 1, dtype=torch.float32,
                        device=logits.device)[:, None]
    precision = torch.cumsum(y_sorted, 0) / rank
    aps = (precision * y_sorted).sum(0) / torch.clamp(y_sorted.sum(0),
                                                      min=1.0)
    present = y.sum(0) > 0
    return (torch.where(present, aps, torch.zeros_like(aps)).sum()
            / torch.clamp(present.sum(), min=1).float())


def top_k_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                   k: int = 5) -> torch.Tensor:
    """The share of samples whose k top-scored classes hold a true
    label."""
    k = min(k, logits.shape[-1])
    topk = torch.argsort(-logits, dim=-1, stable=True)[:, :k]
    hit = torch.gather(labels, -1, topk).sum(-1) > 0
    return hit.float().mean()
