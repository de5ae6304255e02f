"""Motion-grid labels for S3VAE's DFP loss, made on the device.

Counterpart of ``motion_grid_labels`` in ``ode_rl_tpu/data/flow_labels.py``:
the frame-difference magnitude of each transition, averaged over the cells
of a ``grid`` x ``grid`` split of the frame, and a label of 1 on every
cell whose mean is at least the ``topk``-th largest. A cell that ties
with that value is labelled too, so a transition may carry more than
``topk`` ones: on a Moving MNIST frame with motion in fewer than ``topk``
cells, every still cell ties at 0 and all ``grid``^2 labels are 1.
``torch.topk`` would pick exactly ``topk`` of them, so it is not used.

The FlowNet label source (``flow_grid_labels``, ``make_flownet_label_fn``)
is not ported (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import torch


def _grid_topk(mag: torch.Tensor, grid: int, topk: int) -> torch.Tensor:
    """(B, T, H, W, 1) magnitude map -> (B, T, grid^2) multi-hot."""
    b, t, h, w, _ = mag.shape
    gh, gw = h // grid, w // grid
    cells = mag[:, :, :gh * grid, :gw * grid].reshape(
        b, t, grid, gh, grid, gw, 1)
    m = cells.mean(dim=(3, 5, 6)).reshape(b, t, grid * grid)
    kth = torch.sort(m, dim=-1).values[..., -topk, None]
    return (m >= kth).to(mag.dtype)


def motion_grid_labels(video: torch.Tensor, grid: int = 3,
                       topk: int = 3) -> torch.Tensor:
    """(B, T, H, W, C) video in [0, 1] -> (B, T-1, grid^2) multi-hot."""
    diff = torch.abs(video[:, 1:] - video[:, :-1]).mean(dim=-1, keepdim=True)
    return _grid_topk(diff, grid, topk)
