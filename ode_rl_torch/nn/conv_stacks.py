"""Convolutional encoder/decoder stacks and the ODE dynamics convnet.

Counterpart of ``ode_rl_tpu/nn/conv_stacks.py``. Every public module takes
and returns NHWC. ``nn.Conv``-style layers keep torch's OIHW ``weight``
and call ``F.conv2d`` on the channels_last view ``x.permute(0, 3, 1, 2)``;
``Conv3x3``, the layer of the ODE field, keeps flax's HWIO ``kernel``,
whose reshape to (9*Cin, Cout) is the layout kernels K1/K2 take.

Parameters start as flax's do: lecun-normal kernels (truncated normal,
fan-in scaled) and zero biases, drawn from an explicit generator.

Inside a mesh the layers take their share of the step (parallel/):

* a layer whose weights hold a ``'model'`` slice of its output channels
  (``parallel.tp.shard_params_tp``) computes that slice on its
  replicated input and all-gathers the channels
  (``parallel.tp.column_parallel``; ``Conv3x3`` through K1/K2 in
  ``column_conv3x3``), then adds its replicated bias;
* under a ``'space'`` axis every map holds this rank's rows: a conv
  takes the rows its kernel reaches across the cut from its neighbours
  (``parallel.sp.halo_rows``) and runs unpadded along H; ``Conv3x3``
  runs K1/K2 on the rank's own rows with the row across each cut as
  their halo operand (``parallel.sp.space_conv3x3``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.ops.conv3x3 import conv3x3_same
from ode_rl_torch.parallel.sp import (conv_halo, halo_rows, space_conv3x3,
                                      space_mesh, transposed_halo)
from ode_rl_torch.parallel.tp import (column_conv3x3, column_parallel,
                                      is_sharded, model_mesh)

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


def _conv_rows(x: torch.Tensor, weight: torch.Tensor, stride: int,
               padding: int, dtype: torch.dtype) -> torch.Tensor:
    """F.conv2d on NHWC, this rank's rows with their halo under a
    ``'space'`` axis."""
    pad = padding
    mesh = space_mesh()
    if mesh is not None:
        x = halo_rows(x, *conv_halo(weight.shape[-2], stride, padding),
                      mesh)
        pad = (0, padding)
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), weight.to(dtype),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], stride: int, padding: int,
                dtype: torch.dtype, sharded: bool = False) -> torch.Tensor:
    """``nn.Conv`` on NHWC: operands in ``dtype``, bias (where there is
    one) added after the conv in ``dtype`` (two roundings under bf16, as
    flax). ``sharded`` (``weight`` is a ``'model'`` slice of the output
    channels) makes it column-parallel."""
    conv = lambda xx: _conv_rows(xx, weight, stride, padding, dtype)
    y = (column_parallel(x, conv, model_mesh("a Conv")) if sharded
         else conv(x))
    return y if bias is None else y + bias.to(dtype)


class Conv(nn.Module):
    """``nn.Conv(features, (k, k), strides, padding, use_bias)``: OIHW
    weight."""

    def __init__(self, cin: int, cout: int, kernel_size: int, *,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = lecun_normal((cout, cin, k, k), k * k * cin, generator)
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x, self.weight, self.bias, self.stride,
                           self.padding, self.dtype, is_sharded(self))


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

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        mesh = space_mesh()
        w = self.weight.to(self.dtype)
        if mesh is None:
            y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2), w,
                                   stride=2, padding=1)
        else:
            top, bottom, first = transposed_halo(4, 2, 1)
            h = x.shape[1]
            x = halo_rows(x, top, bottom, mesh)
            y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2), w,
                                   stride=2, padding=(0, 1))
            y = y[:, :, first:first + 2 * h]
        return y.permute(0, 2, 3, 1).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (column_parallel(x, self._rows, model_mesh("a ConvTranspose"))
             if is_sharded(self) else self._rows(x))
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
        x = x.to(self.dtype).contiguous()
        kernel = self.kernel.to(self.dtype)
        cin, cout = kernel.shape[2], kernel.shape[3]
        mesh = space_mesh()
        if mesh is not None:
            y = space_conv3x3(x, kernel.reshape(9 * cin, cout), mesh)
        elif is_sharded(self, "kernel"):
            y = column_conv3x3(x, kernel.reshape(9 * cin, cout),
                               model_mesh("a Conv3x3"))
        else:
            y = conv3x3_same(x, kernel)
        return y + self.bias.to(self.dtype)


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
