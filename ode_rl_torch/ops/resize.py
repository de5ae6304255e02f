"""Bilinear resize as ``jax.image.resize(x, shape, "bilinear")`` computes it.

JAX's default is ``antialias=True``: downsampling by s widens the triangle
filter by s and renormalises the weights at the edges; upsampling is plain
bilinear with half-pixel centres and edge clamping. ``F.interpolate``'s
antialiased bilinear mode computes the same weights (a CPU test holds it to
``jax.image.resize`` in both directions).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """NHWC (B, H, W, C) -> (B, height, width, C), computed in fp32 (the
    antialiased mode has no bf16 version) and returned in x's dtype."""
    out = F.interpolate(x.float().permute(0, 3, 1, 2), size=(height, width),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).to(x.dtype)
