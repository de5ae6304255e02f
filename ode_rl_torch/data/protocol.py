"""Batch-dict protocol.

Counterpart of ``ode_rl_tpu/data/protocol.py`` without flow labels:
normalised timestamps ``arange(0, T) / T`` split into ``observed_tp`` and
``tp_to_predict``, the observed/predicted frame split, and masks.
"""

from __future__ import annotations

from typing import Dict

import torch


def timestamps_for(n_in: int, n_out: int, device=None):
    """(observed_tp, tp_to_predict) fp32: arange(0, T)/T split at n_in."""
    total = n_in + n_out
    ts = torch.arange(0, total, dtype=torch.float32, device=device) / total
    return ts[:n_in], ts[n_in:]


def make_batch_dict(video: torch.Tensor, n_in: int
                    ) -> Dict[str, torch.Tensor]:
    """Split a (B, T, H, W, C) video in [-0.5, 0.5] into the batch dict;
    every frame is observed (all-ones masks)."""
    b, t = video.shape[:2]
    n_out = t - n_in
    observed_tp, tp_to_predict = timestamps_for(n_in, n_out, video.device)
    mask = torch.ones((b, t), dtype=video.dtype, device=video.device)
    return {
        "observed_data": video[:, :n_in],
        "data_to_predict": video[:, n_in:],
        "observed_tp": observed_tp,
        "tp_to_predict": tp_to_predict,
        "observed_mask": mask[:, :n_in],
        "mask_predicted_data": mask[:, n_in:],
    }
