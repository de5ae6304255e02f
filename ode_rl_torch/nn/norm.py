"""BatchNorm, LayerNorm and GroupNorm with flax's numbers.

Counterparts of ``flax.linen.BatchNorm`` (as the S3VAE frame stacks build
it: ``momentum=0.9``, ``epsilon=1e-5``), ``flax.linen.LayerNorm``
(``epsilon=1e-6``) and ``flax.linen.GroupNorm`` (``epsilon=1e-6``, groups
of contiguous channels on the last axis, moments over every axis but the
batch's). BatchNorm and LayerNorm normalise over every axis but the last,
so they take NHWC maps and (..., C) vectors alike; all three take the
moments as flax does: in fp32 at least (fp64 stays fp64), var = E[x^2] -
E[x]^2 clamped at 0.

``nn.BatchNorm2d`` is not a stand-in: it keeps the unbiased batch variance
in its running statistics where flax keeps the biased one, and its
``momentum=0.1`` weighs the batch as flax's ``momentum=0.9`` does, so the
two names mean opposite things. The running statistics here are buffers
named as flax's ``batch_stats`` leaves (``mean``, ``var``), so
``state_dict`` and checkpoints carry them.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ode_rl_torch.parallel.mesh import global_sum, world


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in its dtype promoted to at least fp32, as flax takes moments."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance over every axis but the last."""
    xf = _acc(x)
    axes = tuple(range(x.ndim - 1))
    mean = xf.mean(dim=axes)
    var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
    return mean, var


def _global_moments(x: torch.Tensor, n_ranks: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_moments`` of the global batch: the ranks' sums of x and x^2
    all-reduced in one call, with their gradients."""
    xf = _acc(x)
    axes = tuple(range(x.ndim - 1))
    sums = global_sum(torch.stack([xf.sum(dim=axes),
                                   (xf * xf).sum(dim=axes)]))
    count = x.numel() // x.shape[-1] * n_ranks
    mean, mean_sq = sums[0] / count, sums[1] / count
    return mean, torch.clamp(mean_sq - mean * mean, min=0.0)


def _normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """flax's ``_normalize``: (x - mean) * (rsqrt(var + eps) * scale) +
    bias, in at least fp32, cast back to x's dtype."""
    mul = torch.rsqrt(var + eps) * scale
    return ((_acc(x) - mean) * mul + bias).to(x.dtype)


class BatchNorm(nn.Module):
    """In training: normalise by the batch's moments and move the running
    ones, running = momentum * running + (1 - momentum) * batch, with the
    biased variance. In eval: normalise by the running moments. Inside a
    data-parallel mesh the moments are the global batch's, so the running
    ones stay equal on every rank."""

    MOMENTUM, EPS = 0.9, 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return _normalize(x, self.mean, self.var, self.scale, self.bias,
                              self.EPS)
        n_ranks = world()
        mean, var = (_moments(x) if n_ranks == 1
                     else _global_moments(x, n_ranks))
        with torch.no_grad():
            m = self.MOMENTUM
            self.mean.mul_(m).add_((1.0 - m) * mean.detach())
            self.var.mul_(m).add_((1.0 - m) * var.detach())
        return _normalize(x, mean, var, self.scale, self.bias, self.EPS)


class LayerNorm(nn.Module):
    """Normalise each vector over its last axis, then scale and bias."""

    EPS = 1e-6

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = _acc(x)
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True)
                          - mean * mean, min=0.0)
        return _normalize(x, mean, var, self.scale, self.bias, self.EPS)


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm(num_groups)`` on (B, ..., C): each sample's
    ``num_groups`` groups of C / num_groups contiguous channels
    normalised over their channels and every spatial axis, then scaled
    and biased per channel. Not ``torch.nn.GroupNorm``, whose eps is
    1e-5 and which takes channels first."""

    EPS = 1e-6

    def __init__(self, features: int, num_groups: int):
        super().__init__()
        self.num_groups = num_groups
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.num_groups
        xg = _acc(x).reshape(*x.shape[:-1], g, x.shape[-1] // g)
        axes = tuple(range(1, x.ndim - 1)) + (-1,)
        mean = xg.mean(dim=axes, keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=axes, keepdim=True)
                          - mean * mean, min=0.0)
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        mean = mean.expand(*mean.shape[:-1], x.shape[-1] // g).reshape(shape)
        var = var.expand(*var.shape[:-1], x.shape[-1] // g).reshape(shape)
        return _normalize(x, mean, var, self.scale, self.bias, self.EPS)
