"""Bilinear warping: ``grid_sample`` and ``resample2d``.

Counterpart of ``ode_rl_tpu/ops/warp.py``, which has no Pallas kernel: both
are ``F.grid_sample(mode="bilinear", padding_mode="border",
align_corners=False)``; ``resample2d`` turns pixel coordinates into grid
coordinates, gx = (2*ix + 1)/W - 1. Sample coordinates are clamped to the
image, so a flow that pushes a sample past the border reads the edge pixel
and gets no gradient along that axis. JAX's clip gives half its gradient
at a sample that lands exactly on the edge, torch's none; elsewhere the
two agree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample (B,H,W,C) at the normalized grid (B,Ho,Wo,2) of (gx, gy) in
    [-1, 1], with torch's conventions (align_corners=False), border-clamped."""
    out = F.grid_sample(image.permute(0, 3, 1, 2), grid.to(image.dtype),
                        mode="bilinear", padding_mode="border",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)


def resample2d(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp: out[y, x] = image[y + v, x + u] for the flow
    (B,H,W,2) = (u, v) in pixels, border-clamped."""
    b, h, w, c = image.shape
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)
    ix = xs[None, None, :] + flow[..., 0]
    iy = ys[None, :, None] + flow[..., 1]
    grid = torch.stack([(2.0 * ix + 1.0) / w - 1.0,
                        (2.0 * iy + 1.0) / h - 1.0], dim=-1)
    return grid_sample(image, grid)
