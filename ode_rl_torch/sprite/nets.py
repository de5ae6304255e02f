"""DCGAN frame encoder and decoder of the Sprites DS-VAE.

Counterpart of ``ode_rl_tpu/sprite/nets.py``: four stride-2 4x4 convs
(64x64 -> 4x4; BatchNorm from the second, flax's numbers, nn/norm.py)
with leaky_relu 0.2, then a 4x4 VALID conv to ``g_dim`` with BatchNorm
and tanh; the decoder mirrors it with 4x4 transposed convs, ``d1``
VALID from 1x1 (torch's padding 0) and ``d2``-``d5`` 'SAME' at stride 2
(torch's padding 1), each kernel flax's flipped (convert.py), ending in
the sigmoid. Every module takes NHWC and ``train``.
"""

from __future__ import annotations

import torch
from torch import nn

from ode_rl_torch.nn.conv_stacks import Conv, ConvTranspose, leaky_relu
from ode_rl_torch.nn.norm import BatchNorm
from ode_rl_torch.nn.s3vae_nets import ConvTransposeStride1


class DCGANEncoder(nn.Module):
    def __init__(self, in_ch: int = 3, g_dim: int = 128, nf: int = 64, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.g_dim = g_dim
        widths = (nf, 2 * nf, 4 * nf, 8 * nf)
        cin = in_ch
        for i, f in enumerate(widths, start=1):
            self.add_module(f"c{i}", Conv(cin, f, 4, stride=2, padding=1,
                                          **kw))
            if i > 1:
                self.add_module(f"b{i}", BatchNorm(f))
            cin = f
        self.c5 = Conv(cin, g_dim, 4, **kw)
        self.b5 = BatchNorm(g_dim)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """(B, 64, 64, C) -> (B, g_dim)."""
        x = leaky_relu(self.c1(x), 0.2)
        for i in (2, 3, 4):
            x = leaky_relu(getattr(self, f"b{i}")(
                getattr(self, f"c{i}")(x), train), 0.2)
        x = torch.tanh(self.b5(self.c5(x), train))
        return x.reshape(x.shape[0], self.g_dim)


class DCGANDecoder(nn.Module):
    def __init__(self, din: int, out_channels: int = 3, nf: int = 64, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.d1 = ConvTransposeStride1(din, 8 * nf, **kw)
        self.b1 = BatchNorm(8 * nf)
        cin = 8 * nf
        for i, f in enumerate((4 * nf, 2 * nf, nf), start=2):
            self.add_module(f"d{i}", ConvTranspose(cin, f, **kw))
            self.add_module(f"b{i}", BatchNorm(f))
            cin = f
        self.d5 = ConvTranspose(cin, out_channels, **kw)

    def forward(self, z: torch.Tensor, train: bool) -> torch.Tensor:
        """(B, D) -> (B, 64, 64, C) in (0, 1)."""
        x = z.reshape(z.shape[0], 1, 1, -1)
        for i in (1, 2, 3, 4):
            x = leaky_relu(getattr(self, f"b{i}")(
                getattr(self, f"d{i}")(x), train), 0.2)
        return torch.sigmoid(self.d5(x))
