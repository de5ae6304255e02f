"""3-D conv encoders and the slot CNN decoders.

Counterpart of ``ode_rl_tpu/nn/c3d.py``:

* ``Conv3d`` is ``nn.Conv`` with a 3-D kernel on NDHWC videos: torch's
  (O, I, kd, kh, kw) ``weight`` (flax's (kd, kh, kw, I, O) kernel
  transposed, convert.py) and ``F.conv3d`` on the (B, C, T, H, W) view;
* ``C3DEncoder``: five Conv3d stages with leaky_relu 0.2 and a final
  tanh. The 'default' plan is kernel (3, 4, 4), stride (1, 2, 2) and
  padding (0, 1, 1) at every stage (time shrinks by 2 a stage, space
  halves); 'cgru' strides time by 2 in three stages, padding it by 1,
  and ends at 4x4. ``instance_norm`` normalises each sample's channels
  over (T, H, W) with the biased variance, eps 1e-5 and no affine;
* ``SlotCNNDecoder``: a transposed conv to 256 channels ('s2vae': 4x4
  VALID from 1x1; 'cs2vae'/'ds2vae': 3x3 SAME at stride 1, which is
  torch's padding 1 on the flipped kernel), then four 2x nearest
  upsamples (a repeat) with 3x3 convs, each with BatchNorm (nn/norm.py,
  flax's numbers) and leaky_relu 0.2, a 1x1 conv and the sigmoid.
  ``unmasked=False`` adds the alpha channel.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.nn.conv_stacks import Conv, leaky_relu, lecun_normal
from ode_rl_torch.nn.norm import BatchNorm
from ode_rl_torch.nn.s3vae_nets import ConvTransposeStride1, upsample2


class Conv3d(nn.Module):
    """``nn.Conv(features, (kd, kh, kw), strides, padding)`` on NDHWC with
    symmetric padding per axis."""

    def __init__(self, cin: int, cout: int, kernel: Sequence[int],
                 stride: Sequence[int], padding: Sequence[int], *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        kd, kh, kw = kernel
        self.stride, self.padding, self.dtype = (tuple(stride),
                                                 tuple(padding), dtype)
        self.weight = lecun_normal((cout, cin, kd, kh, kw),
                                   kd * kh * kw * cin, generator)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv3d(x.to(self.dtype).permute(0, 4, 1, 2, 3),
                     self.weight.to(self.dtype), stride=self.stride,
                     padding=self.padding)
        return y.permute(0, 2, 3, 4, 1).contiguous() + self.bias.to(
            self.dtype)


# (features, kernel, stride, padding) of each stage; None is the encoder's
# out_channels.
_DEFAULT_STAGE = ((3, 4, 4), (1, 2, 2), (0, 1, 1))
C3D_PLANS = {
    "default": [(f, *_DEFAULT_STAGE) for f in (64, 128, 256, 512, None)],
    "cgru": [(64, (3, 4, 4), (1, 2, 2), (0, 1, 1)),
             (128, (3, 4, 4), (2, 2, 2), (1, 1, 1)),
             (256, (3, 3, 3), (2, 1, 1), (1, 1, 1)),
             (512, (3, 3, 3), (2, 1, 1), (1, 1, 1)),
             (None, (3, 4, 4), (1, 2, 2), (0, 1, 1))],
}


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """Each sample's channels over (T, H, W): biased variance, eps 1e-5,
    no affine."""
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    var = x.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


class C3DEncoder(nn.Module):
    """(B, T, H, W, cin) -> (B, T', H', W', out_channels). JAX's modes
    other than 'cgru' ('static', 'dynamic') take the 'default' plan."""

    def __init__(self, cin: int, out_channels: int, mode: str = "default",
                 instance_norm: bool = False, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        plan = C3D_PLANS["cgru" if mode == "cgru" else "default"]
        self.n, self.instance_norm = len(plan), instance_norm
        for i, (f, k, s, p) in enumerate(plan):
            f = out_channels if f is None else f
            self.add_module(f"conv_{i}", Conv3d(cin, f, k, s, p, dtype=dtype,
                                                generator=generator))
            cin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"conv_{i}")(x)
            if self.instance_norm:
                x = _instance_norm(x)
            x = torch.tanh(x) if i == self.n - 1 else leaky_relu(x, 0.2)
        return x


class SlotCNNDecoder(nn.Module):
    """(N, h, w, cin) -> (N, 16 h, 16 w, out_channels [+ 1]) in (0, 1):
    1x1 -> 64x64 for 's2vae', 4x4 -> 64x64 for 'cs2vae'/'ds2vae'."""

    WIDTHS = (128, 64, 32, 16)

    def __init__(self, cin: int, out_channels: int, variant: str = "s2vae",
                 unmasked: bool = True, *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.deconv_in = (ConvTransposeStride1(cin, 256, **kw)
                          if variant == "s2vae" else
                          ConvTransposeStride1(cin, 256, 3, padding=1, **kw))
        self.bn_in = BatchNorm(256)
        c = 256
        for i, f in enumerate(self.WIDTHS):
            self.add_module(f"conv_{i}", Conv(c, f, 3, padding=1, **kw))
            self.add_module(f"bn_{i}", BatchNorm(f))
            c = f
        self.conv_out = Conv(c, out_channels + (0 if unmasked else 1), 1,
                             **kw)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = leaky_relu(self.bn_in(self.deconv_in(x), train), 0.2)
        for i in range(len(self.WIDTHS)):
            x = getattr(self, f"conv_{i}")(upsample2(x))
            x = leaky_relu(getattr(self, f"bn_{i}")(x, train), 0.2)
        return torch.sigmoid(self.conv_out(x))
