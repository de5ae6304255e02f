"""Dreamer's encoder, decoder and dense heads.

Counterpart of ``ode_rl_tpu/wm/networks.py``. Frames are NHWC, as in JAX:

* ``ConvEncoder``: four 4x4 stride-2 'VALID' convs (``h0``-``h3``) with
  the depth doubling, 64 -> 31 -> 14 -> 6 -> 2, each followed by the
  activation; the last map is flattened in NHWC order, as flax flattens
  it (the port's ``Conv`` returns NHWC, so the flatten is flax's);
* ``ConvDecoder``: Dense ``hin`` -> a 1x1 map of 32 * depth -> four
  stride-2 'VALID' transposed convs with kernels 5, 5, 6, 6 (1 -> 5 ->
  13 -> 30 -> 64), the activation between, then a crop to the frame;
  the mean of a Normal(mean, 1) image likelihood;
* ``DenseHead``: ``layers`` Dense ``h{i}`` of ``units`` with the
  activation, then ``hmean``; ``log_prob`` under 'normal', 'binary' or
  'huber', summed over the head's event axes.

``ConvTransposeValid`` is flax's ``nn.ConvTranspose(strides=2,
padding='VALID')``: flax pads the stride-dilated input by k - 1 on both
sides and convolves with its kernel, which is torch's
``conv_transpose2d(stride=2, padding=0)`` with the kernel flipped
spatially (convert.py flips it by this type).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.nn.conv_stacks import Conv, lecun_normal
from ode_rl_torch.nn.dense import Dense

ACTS = {"elu": F.elu, "relu": F.relu, "silu": F.silu, "tanh": torch.tanh}


class ConvTransposeValid(nn.Module):
    """k x k stride-2 'VALID' transposed conv on NHWC: (H - 1) * 2 + k
    out; torch's (in, out, k, k) ``weight``."""

    def __init__(self, cin: int, cout: int, kernel_size: int, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        k = kernel_size
        self.dtype = dtype
        self.weight = lecun_normal((cin, cout, k, k), k * k * cin, generator)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2),
                               self.weight.to(self.dtype), stride=2)
        return y.permute(0, 2, 3, 1).contiguous() + self.bias.to(self.dtype)


def encoder_size(image_shape: Tuple[int, int, int], depth: int,
                 kernels: Sequence[int] = (4, 4, 4, 4)) -> int:
    """The width of ``ConvEncoder``'s flattened output."""
    h, w = image_shape[:2]
    for k in kernels:
        h, w = (h - k) // 2 + 1, (w - k) // 2 + 1
    return h * w * 2 ** (len(kernels) - 1) * depth


class ConvEncoder(nn.Module):
    def __init__(self, in_channels: int, depth: int = 32, act: str = "relu",
                 kernels: Sequence[int] = (4, 4, 4, 4), *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.act = ACTS[act]
        self.n = len(kernels)
        cin = in_channels
        for i, k in enumerate(kernels):
            self.add_module(f"h{i}", Conv(cin, 2 ** i * depth, k, stride=2,
                                          dtype=dtype, generator=generator))
            cin = 2 ** i * depth

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """(..., H, W, C) -> (..., E)."""
        lead = image.shape[:-3]
        x = image.reshape((-1,) + tuple(image.shape[-3:]))
        for i in range(self.n):
            x = self.act(getattr(self, f"h{i}")(x))
        return x.reshape(tuple(lead) + (-1,))


class ConvDecoder(nn.Module):
    def __init__(self, feat_dim: int, depth: int = 32, act: str = "relu",
                 shape: Tuple[int, int, int] = (64, 64, 1),
                 kernels: Sequence[int] = (5, 5, 6, 6), thin: bool = True, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.act, self.shape, self.depth = ACTS[act], tuple(shape), depth
        self.side = 1 if thin else 2
        self.hin = Dense(feat_dim, 32 * depth * self.side ** 2,
                         generator=generator)
        n = self.n = len(kernels)
        cin = 32 * depth
        for i, k in enumerate(kernels):
            cout = shape[-1] if i == n - 1 else 2 ** (n - i - 2) * depth
            self.add_module(f"h{i}", ConvTransposeValid(
                cin, cout, k, dtype=dtype, generator=generator))
            cin = cout

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """(..., F) -> the mean image (..., H, W, C)."""
        lead = features.shape[:-1]
        x = self.hin(features).reshape(-1, self.side, self.side,
                                       32 * self.depth)
        for i in range(self.n):
            x = getattr(self, f"h{i}")(x)
            if i < self.n - 1:
                x = self.act(x)
        x = x[:, :self.shape[0], :self.shape[1], :]
        return x.reshape(tuple(lead) + self.shape)


def normal_logprob(mean: torch.Tensor, x: torch.Tensor,
                   std: float = 1.0) -> torch.Tensor:
    """log N(x; mean, std), per element."""
    var = std * std
    return -0.5 * (math.log(2.0 * math.pi * var) + (x - mean) ** 2 / var)


class DenseHead(nn.Module):
    def __init__(self, feat_dim: int, shape: Tuple[int, ...] = (),
                 layers: int = 4, units: int = 400, act: str = "elu",
                 dist: str = "normal", std: float = 1.0, *,
                 generator: torch.Generator):
        super().__init__()
        self.shape, self.layers, self.dist, self.std = (tuple(shape), layers,
                                                        dist, std)
        self.act = ACTS[act]
        din = feat_dim
        for i in range(layers):
            self.add_module(f"h{i}", Dense(din, units, generator=generator))
            din = units
        self.hmean = Dense(din, int(math.prod(shape)) if shape else 1,
                           generator=generator)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = features
        for i in range(self.layers):
            x = self.act(getattr(self, f"h{i}")(x))
        return self.hmean(x).reshape(tuple(features.shape[:-1]) + self.shape)

    def log_prob(self, mean: torch.Tensor, target: torch.Tensor
                 ) -> torch.Tensor:
        """Per-sample log-likelihood under the head's distribution."""
        m, t = mean.float(), target.float()
        if self.dist == "normal":
            lp = normal_logprob(m, t, self.std)
        elif self.dist == "binary":
            lp = t * F.logsigmoid(m) + (1 - t) * F.logsigmoid(-m)
        elif self.dist == "huber":
            lp = -(torch.sqrt((t - m) ** 2 + 1.0) - 1.0)
        else:
            raise NotImplementedError(self.dist)
        if not self.shape:
            return lp
        return lp.sum(dim=tuple(range(-len(self.shape), 0)))
