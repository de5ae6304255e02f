"""Evaluation metrics: MSE, PSNR, SSIM.

Counterpart of ``ode_rl_tpu/train/metrics.py``: per-frame MSE,
PSNR = 10 log10(1 / MSE) on [0, 1] frames, and SSIM on x255 frames with
the skimage settings (Gaussian weights, no sample covariance: a separable
11x11 Gaussian with sigma 1.5, 'valid', K1 = 0.01, K2 = 0.03). The
windowed moments are depthwise convolutions on the frames' device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    m = mse(pred, target)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(m, min=1e-12))


def _gaussian_kernel(truncate: float = 3.5, sigma: float = 1.5) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)  # skimage: 11x11 for sigma 1.5
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _filter2d(img: torch.Tensor, kernel1d: np.ndarray) -> torch.Tensor:
    """Separable 'valid' Gaussian filter over (B, H, W, C)."""
    b, h, w, c = img.shape
    k = torch.from_numpy(kernel1d).to(img.device)
    x = img.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    x = F.conv2d(x, k.reshape(1, 1, -1, 1))
    x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    return x.reshape(b, c, x.shape[2], x.shape[3]).permute(0, 2, 3, 1)


def _ssim_map(x: torch.Tensor, y: torch.Tensor, data_range: float,
              sigma: float, k1: float, k2: float) -> torch.Tensor:
    kernel = _gaussian_kernel(sigma=sigma)
    x, y = x.float(), y.float()
    ux, uy = _filter2d(x, kernel), _filter2d(y, kernel)
    uxx, uyy = _filter2d(x * x, kernel), _filter2d(y * y, kernel)
    uxy = _filter2d(x * y, kernel)
    vx = uxx - ux * ux
    vy = uyy - uy * uy
    vxy = uxy - ux * uy
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    num = (2 * ux * uy + c1) * (2 * vxy + c2)
    den = (ux * ux + uy * uy + c1) * (vx + vy + c2)
    return num / den


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 255.0,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03
         ) -> torch.Tensor:
    """Mean SSIM over (B, H, W, C) images (channels averaged)."""
    return torch.mean(_ssim_map(pred, target, data_range, sigma, k1, k2))


def per_frame_metrics(pred: torch.Tensor, target: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
    """Per-horizon metrics of (B, T, H, W, C) videos in [0, 1]: a dict of
    (T,) tensors ``mse``, ``psnr`` (on [0, 1]) and ``ssim`` (on x255)."""
    t = pred.shape[1]
    m = torch.mean(torch.square(pred - target), dim=(0, 2, 3, 4))
    frames = lambda v: (v.movedim(1, 0) * 255.0).reshape(-1, *v.shape[2:])
    s = _ssim_map(frames(pred), frames(target), 255.0, 1.5, 0.01, 0.03)
    return {"mse": m,
            "psnr": 10.0 * torch.log10(1.0 / torch.clamp(m, min=1e-12)),
            "ssim": s.reshape(t, -1).mean(dim=1)}
