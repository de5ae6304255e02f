"""Optical-flow training losses.

Counterpart of ``ode_rl_tpu/flow/losses.py``: EPE, L1/L2 and the two
multiscale losses over a pyramid of NHWC flows, finest first. Mixed
dtypes promote as in JAX: a bf16 flow against an fp32 target is compared
in fp32.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ode_rl_torch.ops.resize import resize_bilinear


def epe(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean endpoint error over (B, H, W, 2) flows."""
    return torch.linalg.vector_norm(pred - target, dim=-1).mean()


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - target).mean()


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(pred - target, dim=-1).mean()


def multiscale_loss(
    flow_pyramid: Sequence[torch.Tensor],
    target: torch.Tensor,
    weights: Sequence[float] = (0.32, 0.08, 0.02, 0.01, 0.005),
    start_scale: int = 4,
    norm: str = "l1",
) -> torch.Tensor:
    """Weighted sum of per-scale losses, finest prediction first. Each
    level's target is the bilinear (antialiased) resize of ``target``
    divided by the level's scale, so it is in that level's pixel units."""
    loss_fn = l1_loss if norm == "l1" else l2_loss
    b, h, w, c = target.shape
    total = 0.0
    for i, flow in enumerate(flow_pyramid):
        scale = start_scale * (2 ** i)
        tgt = resize_bilinear(target, h // scale, w // scale) / scale
        total = total + weights[i] * loss_fn(flow, tgt)
    return total


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """AvgPool2d(kernel=stride=k) on NHWC."""
    b, h, w, c = x.shape
    return x.reshape(b, h // k, k, w // k, k, c).mean(dim=(2, 4))


def multiscale_loss_reference(
    flow_pyramid: Sequence[torch.Tensor],
    target: torch.Tensor,
    weights: Sequence[float] = (0.32, 0.16, 0.08, 0.04, 0.02),
    start_scale: int = 4,
    norm: str = "l1",
    div_flow: float = 0.05,
):
    """The flownet2-pytorch MultiScale loss: target scaled once by
    ``div_flow``, average-pooled to each level, weighted. Returns
    (loss, weighted EPE)."""
    loss_fn = l1_loss if norm == "l1" else l2_loss
    target = div_flow * target
    total, epe_total = 0.0, 0.0
    for i, flow in enumerate(flow_pyramid):
        tgt = _avg_pool(target, start_scale * (2 ** i))
        total = total + weights[i] * loss_fn(flow, tgt)
        epe_total = epe_total + weights[i] * epe(flow, tgt)
    return total, epe_total
