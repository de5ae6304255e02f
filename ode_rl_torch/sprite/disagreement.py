"""Disagreement scores of the DS-VAE disentanglement evaluation (numpy).

Counterpart of ``ode_rl_tpu/sprite/disagreement.py``, copied: generate
videos with one factor fixed and the other resampled, classify the
originals (pred1) and the generations (pred2) with a trained judge, then

* acc: agreement between the argmaxes of pred1 and pred2;
* kl: KL(pred2 || pred1) averaged over samples;
* IS: the inception score of pred2 on a class-balanced subset;
* H_yx: the mean entropy of pred2's rows (balanced subset);
* H_y: the entropy of pred2's marginal class distribution (balanced).

The balanced subset keeps the same number of samples of each
ground-truth class.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_EPS = 1e-16


def entropy_hy(p_yx: np.ndarray, eps: float = _EPS) -> float:
    """Entropy of the marginal class distribution."""
    p_y = p_yx.mean(axis=0)
    return float(-(p_y * np.log(p_y + eps)).sum())


def entropy_hyx(p_yx: np.ndarray, eps: float = _EPS) -> float:
    """Mean per-sample entropy."""
    return float(-np.mean((p_yx * np.log(p_yx + eps)).sum(axis=1)))


def inception_score(p_yx: np.ndarray, eps: float = _EPS) -> float:
    """exp(mean KL(p(y|x) || p(y)))."""
    p_y = np.expand_dims(p_yx.mean(axis=0), 0)
    kl = (p_yx * (np.log(p_yx + eps) - np.log(p_y + eps))).sum(axis=1)
    return float(np.exp(np.mean(kl)))


def kl_divergence(p: np.ndarray, q: np.ndarray, eps: float = _EPS) -> float:
    """Mean per-sample KL(p || q) over class rows."""
    kl = (p * (np.log(p + eps) - np.log(q + eps))).sum(axis=1)
    return float(np.mean(kl))


def balanced_subset_index(label_gt: np.ndarray) -> np.ndarray:
    """Indices keeping the same number of samples of each ground-truth
    class."""
    n_per = min(int((label_gt == i).sum()) for i in np.unique(label_gt))
    return np.hstack([np.nonzero(label_gt == i)[0][:n_per]
                      for i in np.unique(label_gt)]).squeeze()


def disagreement_scores(pred1: np.ndarray, pred2: np.ndarray,
                        label_gt: np.ndarray) -> Dict[str, float]:
    """pred1: the judge on the source videos; pred2: the judge on the
    generations with that factor fixed and the other resampled; rows are
    probability distributions."""
    label1 = np.argmax(pred1, axis=1)
    label2 = np.argmax(pred2, axis=1)
    idx = balanced_subset_index(np.asarray(label_gt))
    p2_sel = pred2[idx]
    return {
        "acc": float((label1 == label2).mean()),
        "kl": kl_divergence(pred2, pred1),
        "IS": inception_score(p2_sel),
        "H_yx": entropy_hyx(p2_sel),
        "H_y": entropy_hy(p2_sel),
    }
