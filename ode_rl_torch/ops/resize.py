"""Bilinear and bicubic resize as ``jax.image.resize`` computes them.

JAX's default is ``antialias=True``: downsampling by s widens the triangle
filter by s and renormalises the weights at the edges; upsampling is plain
bilinear with half-pixel centres and edge clamping. ``F.interpolate``'s
antialiased bilinear mode computes the same weights (a CPU test holds it to
``jax.image.resize`` in both directions).

JAX's bicubic is the Keys kernel with a = -0.5, its weights renormalised
where the kernel reaches past the edge. ``F.interpolate``'s antialiased
bicubic mode computes those weights; its plain bicubic mode takes a =
-0.75 and clamps the edge instead, 0.2 away at a 4x4 -> 64x64 upsample.
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


def resize_bicubic(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """NHWC (B, H, W, C) -> (B, height, width, C) as ``jax.image.resize(x,
    shape, "bicubic")``, computed in fp32 and returned in x's dtype."""
    out = F.interpolate(x.float().permute(0, 3, 1, 2), size=(height, width),
                        mode="bicubic", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).to(x.dtype)
