"""Convolutional encoder/decoder stacks and the ODE dynamics convnet.

Counterpart of ``ode_rl_tpu/nn/conv_stacks.py``. Every public module takes
and returns NHWC. ``nn.Conv``-style layers keep torch's OIHW ``weight``
and call ``F.conv2d`` on the channels_last view ``x.permute(0, 3, 1, 2)``;
``Conv3x3``, the layer of the ODE field, keeps flax's HWIO ``kernel``,
whose reshape to (9*Cin, Cout) is the layout kernels K1/K2 take.

Parameters start as flax's do: lecun-normal kernels (truncated normal,
fan-in scaled) and zero biases, drawn from an explicit generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.ops.conv3x3 import conv3x3_same

# Std of a unit normal truncated to [-2, 2]; flax divides by it.
_TRUNC_STD = 0.87962566103423978


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: its gradient at exactly 0 is 1, where
    ``F.leaky_relu``'s is the slope. Exact zeros are common here: a zero
    bias on the zero background of a Moving MNIST frame."""
    return torch.where(x >= 0, x, x * slope)


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return leaky_relu(x, 0.2)


def lecun_normal(shape: tuple, fan_in: int,
                 generator: torch.Generator) -> nn.Parameter:
    """flax's ``lecun_normal()``: truncated normal of variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    return nn.Parameter(w)


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                stride: int, padding: int, dtype: torch.dtype) -> torch.Tensor:
    """``nn.Conv`` on NHWC: operands in ``dtype``, bias added after the
    conv in ``dtype`` (two roundings under bf16, as flax)."""
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), weight.to(dtype),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous() + bias.to(dtype)


class Conv(nn.Module):
    """``nn.Conv(features, (k, k), strides, padding)``: OIHW weight."""

    def __init__(self, cin: int, cout: int, kernel_size: int, *,
                 stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = lecun_normal((cout, cin, k, k), k * k * cin, generator)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x, self.weight, self.bias, self.stride,
                           self.padding, self.dtype)


class ConvTranspose(nn.Module):
    """``nn.ConvTranspose(features, (4, 4), strides=(2, 2), 'SAME')``.

    The weight is torch's (in, out, 4, 4) for ``conv_transpose2d(stride=2,
    padding=1)``; a flax kernel converts by a spatial flip (convert.py)."""

    def __init__(self, cin: int, cout: int, *, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = lecun_normal((cin, cout, 4, 4), 16 * cin, generator)
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2),
                               self.weight.to(self.dtype), stride=2,
                               padding=1)
        y = y.permute(0, 2, 3, 1).contiguous()
        return y if self.bias is None else y + self.bias.to(self.dtype)


class ConvEncoder(nn.Module):
    """Stride-2 conv downsampling with leaky_relu(0.2): 64x64 ->
    64/2^n_downs (first width 16, doubling, final out_ch)."""

    def __init__(self, in_ch: int, out_ch: int, n_downs: int = 2, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.n_downs = n_downs
        ch, cin = 16, in_ch
        for i in range(n_downs - 1):
            self.add_module(f"down_{i}", Conv(
                cin, ch, 3, stride=2, padding=1, dtype=dtype,
                generator=generator))
            cin, ch = ch, ch * 2
        self.add_module(f"down_{n_downs - 1}", Conv(
            cin, out_ch, 3, stride=2, padding=1, dtype=dtype,
            generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_downs):
            x = _leaky_relu(getattr(self, f"down_{i}")(x))
        return x


class ConvDecoder(nn.Module):
    """Transposed-conv x2 upsampling per layer (kernel 4, stride 2, first
    width 32, halving), leaky_relu(0.2) between; no final activation (the
    model applies the sigmoid)."""

    def __init__(self, in_ch: int, out_ch: int, n_ups: int = 2, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.n_ups = n_ups
        ch, cin = 32, in_ch
        for i in range(n_ups - 1):
            self.add_module(f"up_{i}", ConvTranspose(
                cin, ch, dtype=dtype, generator=generator))
            cin, ch = ch, ch // 2
        self.add_module(f"up_{n_ups - 1}", ConvTranspose(
            cin, out_ch, dtype=dtype, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_ups - 1):
            x = _leaky_relu(getattr(self, f"up_{i}")(x))
        return getattr(self, f"up_{self.n_ups - 1}")(x)


class Conv3x3(nn.Module):
    """3x3 stride-1 SAME conv with flax's parameters ('kernel' HWIO,
    'bias'), running on kernels K1/K2 (ops/conv3x3.py)."""

    def __init__(self, cin: int, features: int, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.kernel = lecun_normal((3, 3, cin, features), 9 * cin, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3x3_same(x.to(self.dtype).contiguous(),
                            self.kernel.to(self.dtype),
                            self.bias.to(self.dtype))


class ConvNet(nn.Module):
    """3x3 stride-1 conv tower: in -> mid_0..mid_{n-1} -> out, relu
    between; the ODE dynamics field (autonomous: no t argument)."""

    def __init__(self, in_ch: int, out_ch: int, n_layers: int = 2,
                 n_units: int = 64, *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.names = ["in"] + [f"mid_{i}" for i in range(n_layers)] + ["out"]
        widths = [in_ch] + [n_units] * (n_layers + 1) + [out_ch]
        for name, cin, cout in zip(self.names, widths[:-1], widths[1:]):
            self.add_module(name, Conv3x3(cin, cout, dtype=dtype,
                                          generator=generator))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        x = getattr(self, "in")(y)
        for name in self.names[1:]:
            x = getattr(self, name)(F.relu(x))
        return x
