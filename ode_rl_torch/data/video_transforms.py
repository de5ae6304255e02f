"""Video-level augmentation transforms.

Counterpart of ``ode_rl_tpu/data/video_transforms.py``: scale (bilinear,
``ops/resize.py``), center crop, pad, random crop, random horizontal
flip, random rotation (one angle, bilinear, border clamp), color jitter,
cutout and normalize, each over a whole (T, H, W, C) clip with one draw
of its random parameters for the clip, so every frame gets the same
augmentation. The draws come from the caller's ``Noise``
(core/noise.py); ``compose`` hands the same ``Noise`` to every random
transform in turn, where JAX splits its key once a transform.
"""

from __future__ import annotations

import inspect
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ode_rl_torch.core.noise import Noise
from ode_rl_torch.ops.resize import resize_bilinear
from ode_rl_torch.ops.warp import grid_sample, linspace


def scale(clip: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    return resize_bilinear(clip, size[0], size[1])


def center_crop(clip: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    _, h, w, _ = clip.shape
    th, tw = size
    y0, x0 = (h - th) // 2, (w - tw) // 2
    return clip[:, y0:y0 + th, x0:x0 + tw]


def pad(clip: torch.Tensor, padding: int, value: float = 0.0
        ) -> torch.Tensor:
    return F.pad(clip, (0, 0, padding, padding, padding, padding),
                 value=value)


def random_crop(noise: Noise, clip: torch.Tensor, size: Tuple[int, int]
                ) -> torch.Tensor:
    _, h, w, _ = clip.shape
    th, tw = size
    y0 = int(noise.randint(0, h - th + 1, (), clip.device))
    x0 = int(noise.randint(0, w - tw + 1, (), clip.device))
    return clip[:, y0:y0 + th, x0:x0 + tw]


def random_horizontal_flip(noise: Noise, clip: torch.Tensor,
                           p: float = 0.5) -> torch.Tensor:
    flip = noise.uniform((), clip.device) < p
    return torch.where(flip, clip.flip(2), clip)


def rotation_grid(theta: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., H, W, 2) grids rotating by the angles ``theta`` (radians)."""
    ys, xs = torch.meshgrid(linspace(-1.0, 1.0, h, theta.device),
                            linspace(-1.0, 1.0, w, theta.device),
                            indexing="ij")
    c = torch.cos(theta)[..., None, None]
    s = torch.sin(theta)[..., None, None]
    return torch.stack([c * xs - s * ys, s * xs + c * ys], dim=-1)


def random_rotation(noise: Noise, clip: torch.Tensor,
                    degrees: float = 10.0) -> torch.Tensor:
    """Rotate every frame by one angle in [-degrees, degrees)."""
    t, h, w, _ = clip.shape
    angle = noise.uniform((), clip.device, -degrees, degrees)
    grid = rotation_grid(angle * math.pi / 180.0, h, w)
    return grid_sample(clip, grid[None].expand(t, h, w, 2))


def color_jitter(noise: Noise, clip: torch.Tensor, brightness: float = 0.2,
                 contrast: float = 0.2, saturation: float = 0.2
                 ) -> torch.Tensor:
    """One jitter draw a clip (of [0, 1] frames)."""
    b = 1.0 + noise.uniform((), clip.device, -brightness, brightness)
    c = 1.0 + noise.uniform((), clip.device, -contrast, contrast)
    s = 1.0 + noise.uniform((), clip.device, -saturation, saturation)
    out = clip * b
    mean = out.mean(dim=(1, 2, 3), keepdim=True)
    out = (out - mean) * c + mean
    gray = out.mean(dim=-1, keepdim=True)
    out = (out - gray) * s + gray
    return torch.clamp(out, 0.0, 1.0)


def cutout(noise: Noise, clip: torch.Tensor, size: int = 16
           ) -> torch.Tensor:
    """Zero one size x size patch at the same place in every frame."""
    _, h, w, _ = clip.shape
    y0 = noise.randint(0, h - size + 1, (), clip.device)
    x0 = noise.randint(0, w - size + 1, (), clip.device)
    yy = torch.arange(h, device=clip.device)[:, None]
    xx = torch.arange(w, device=clip.device)[None, :]
    hole = (yy >= y0) & (yy < y0 + size) & (xx >= x0) & (xx < x0 + size)
    return clip * (1.0 - hole[None, :, :, None].to(clip.dtype))


def normalize(clip: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    mean = torch.as_tensor(mean, dtype=clip.dtype, device=clip.device)
    std = torch.as_tensor(std, dtype=clip.dtype, device=clip.device)
    return (clip - mean) / std


def compose(noise: Noise, clip: torch.Tensor, transforms) -> torch.Tensor:
    """Apply a list of (fn, kwargs); a random fn (its first parameter is
    ``noise``) draws from ``noise``."""
    for fn, kwargs in transforms:
        if "noise" in inspect.signature(fn).parameters:
            clip = fn(noise, clip, **kwargs)
        else:
            clip = fn(clip, **kwargs)
    return clip
