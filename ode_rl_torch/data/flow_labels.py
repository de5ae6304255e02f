"""Motion-grid labels for S3VAE's DFP loss, made on the device.

Counterpart of ``motion_grid_labels`` in ``ode_rl_tpu/data/flow_labels.py``:
the frame-difference magnitude of each transition, averaged over the cells
of a ``grid`` x ``grid`` split of the frame, and a label of 1 on every
cell whose mean is at least the ``topk``-th largest. A cell that ties
with that value is labelled too, so a transition may carry more than
``topk`` ones: on a Moving MNIST frame with motion in fewer than ``topk``
cells, every still cell ties at 0 and all ``grid``^2 labels are 1.
``torch.topk`` would pick exactly ``topk`` of them, so it is not used.

``flow_grid_labels`` takes the same statistic of a predicted flow, the
per-cell mean of its magnitude (the reference's mean HSV saturation of
the rendered flow), and ``make_flownet_label_fn`` gives the labels of
FlowNetC's flow between consecutive frames: the finest pyramid level
resized bilinearly to the frame and scaled by 4. FlowNetC runs without
autograd, so no gradient of the loss reaches it (its weights are
constants of the step, as JAX's closed-over params are), and its K5
launches in the step have no K6/K7 behind them.
"""

from __future__ import annotations

from typing import Callable

import torch

from ode_rl_torch.ops.resize import resize_bilinear


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


def flow_grid_labels(flow: torch.Tensor, grid: int = 3,
                     topk: int = 3) -> torch.Tensor:
    """(B, T-1, H, W, 2) predicted flow -> (B, T-1, grid^2) multi-hot by
    per-cell mean flow magnitude."""
    mag = torch.sqrt(torch.sum(flow * flow, dim=-1, keepdim=True))
    return _grid_topk(mag, grid, topk)


def make_flownet_label_fn(flownet: torch.nn.Module, grid: int = 3,
                          topk: int = 3) -> Callable[[torch.Tensor],
                                                     torch.Tensor]:
    """``video -> labels``: a (B, T, H, W, C) video in [0, 1] (C < 3
    repeated to 3 channels) -> (B, T-1, grid^2), FlowNetC run on the
    B * (T-1) consecutive pairs in one batch."""

    def label_fn(video: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = video.shape
        img = video if c == 3 else video.repeat_interleave(3, dim=-1)[
            ..., :3]
        i1 = img[:, :-1].reshape(b * (t - 1), h, w, 3)
        i2 = img[:, 1:].reshape(b * (t - 1), h, w, 3)
        with torch.no_grad():
            flows = flownet(i1, i2)
            full = resize_bilinear(flows[0], h, w) * 4.0
        return flow_grid_labels(full.reshape(b, t - 1, h, w, 2), grid, topk)

    return label_fn
