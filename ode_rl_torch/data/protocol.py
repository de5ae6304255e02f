"""Batch-dict protocol.

Counterpart of ``ode_rl_tpu/data/protocol.py``: normalised timestamps
``arange(0, T) / T`` split into ``observed_tp`` and ``tp_to_predict``, the
observed/predicted frame split, masks, and, for S3VAE, the motion-grid
labels of the frame differences or of FlowNetC's flow
(data/flow_labels.py).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ode_rl_torch.data.flow_labels import motion_grid_labels


def timestamps_for(n_in: int, n_out: int, device=None):
    """(observed_tp, tp_to_predict) fp32: arange(0, T)/T split at n_in."""
    total = n_in + n_out
    ts = torch.arange(0, total, dtype=torch.float32, device=device) / total
    return ts[:n_in], ts[n_in:]


def make_batch_dict(video: torch.Tensor, n_in: int,
                    with_flow_labels: bool = False, flow_grid: int = 3,
                    flow_topk: int = 3,
                    flow_label_fn: Optional[Callable] = None
                    ) -> Dict[str, torch.Tensor]:
    """Split a (B, T, H, W, C) video in [-0.5, 0.5] into the batch dict;
    every frame is observed (all-ones masks). ``with_flow_labels`` adds
    ``in_flow_labels`` and ``out_flow_labels``, both the labels of the
    first n_in - 1 transitions, as JAX's are: the frame-difference motion
    grid, or ``flow_label_fn`` of the video in [0, 1] where it is given
    (data/flow_labels.make_flownet_label_fn)."""
    b, t = video.shape[:2]
    n_out = t - n_in
    observed_tp, tp_to_predict = timestamps_for(n_in, n_out, video.device)
    mask = torch.ones((b, t), dtype=video.dtype, device=video.device)
    batch = {
        "observed_data": video[:, :n_in],
        "data_to_predict": video[:, n_in:],
        "observed_tp": observed_tp,
        "tp_to_predict": tp_to_predict,
        "observed_mask": mask[:, :n_in],
        "mask_predicted_data": mask[:, n_in:],
    }
    if with_flow_labels:
        if flow_label_fn is not None:
            labels = flow_label_fn(video + 0.5)
        else:
            labels = motion_grid_labels(video + 0.5, grid=flow_grid,
                                        topk=flow_topk)
        batch["in_flow_labels"] = labels[:, :n_in - 1]
        batch["out_flow_labels"] = labels[:, :n_in - 1]
    return batch
