"""PatchGAN discriminators and LSGAN losses for Vid-ODE's GAN loop.

Counterpart of ``ode_rl_tpu/nn/discriminators.py``:

* ``PatchDiscriminator``: 4x4 convs 64 (stride 2, no bias), 128 and 256
  (stride 2), 512 (stride 1, padding 2), then 64 patch logits (stride 1,
  padding 2, no bias); instance norm after the middle three, leaky relu
  0.2 after all but the last;
* the instance norm is JAX's ``_instance_norm``: each sample's and
  channel's mean and biased variance over (H, W), eps 1e-5, no affine;
* LSGAN: D's 0.5 * [(D(real) - 1)^2 + D(fake)^2], G's (D(fake) - 1)^2;
* the sequence discriminator's inputs: ``rearrange_seq_extrap``, sliding
  windows [context[i:], seq[:i + 1]] channel-stacked (t_ctx + 1 frames a
  window, zero-padded on the left to T where shorter), and
  ``rearrange_seq_interp``, the context with one frame swapped for the
  candidate's, one window a position.
"""

from __future__ import annotations

import torch
from torch import nn

from ode_rl_torch.nn.conv_stacks import Conv, leaky_relu


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """NHWC: normalise each sample's channels over (H, W)."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = torch.square(x - mean).mean(dim=(1, 2), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class PatchDiscriminator(nn.Module):
    def __init__(self, in_ch: int, *, generator: torch.Generator):
        super().__init__()
        kw = dict(generator=generator)
        self.l1 = Conv(in_ch, 64, 4, stride=2, padding=1, use_bias=False,
                       **kw)
        self.l2 = Conv(64, 128, 4, stride=2, padding=1, **kw)
        self.l3 = Conv(128, 256, 4, stride=2, padding=1, **kw)
        self.l4 = Conv(256, 512, 4, stride=1, padding=2, **kw)
        self.last = Conv(512, 64, 4, stride=1, padding=2, use_bias=False,
                         **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> patch logits."""
        x = leaky_relu(self.l1(x), 0.2)
        for layer in (self.l2, self.l3, self.l4):
            x = leaky_relu(instance_norm(layer(x)), 0.2)
        return self.last(x)


def lsgan_d_loss(pred_real: torch.Tensor,
                 pred_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean((pred_real - 1.0) ** 2)
                  + torch.mean(pred_fake ** 2))


def lsgan_g_loss(pred_fake: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred_fake - 1.0) ** 2)


def frames_to_images(video: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B * T, H, W, C)."""
    return video.reshape(-1, *video.shape[2:])


def _stack_windows(stacked: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """(T * B, L, H, W, C) -> (T * B, H, W, L * C), frame-major."""
    _, n, h, w, c = stacked.shape
    return stacked.movedim(1, -2).reshape(b * t, h, w, n * c)


def rearrange_seq_extrap(seq: torch.Tensor,
                         context: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) with context (B, T_ctx, H, W, C) -> (B * T, H, W,
    max(T_ctx + 1, T) * C)."""
    b, t, h, w, c = seq.shape
    out_len = max(context.shape[1] + 1, t)
    outs = []
    for i in range(t):
        window = torch.cat([context[:, i:], seq[:, :i + 1]], dim=1)
        if window.shape[1] < out_len:
            window = torch.cat([window.new_zeros(
                (b, out_len - window.shape[1], h, w, c)), window], dim=1)
        outs.append(window)
    return _stack_windows(torch.cat(outs, dim=0), b, t)


def rearrange_seq_interp(seq: torch.Tensor,
                         context: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) with a context of T frames -> (B * T, H, W, T * C):
    window i is the context with frame i taken from ``seq``."""
    b, t = seq.shape[:2]
    eye = torch.eye(t, dtype=seq.dtype, device=seq.device)
    outs = [(1.0 - m) * context + m * seq
            for m in (eye[i].reshape(1, t, 1, 1, 1) for i in range(t))]
    return _stack_windows(torch.cat(outs, dim=0), b, t)


def seq_channels(t_ctx: int, t: int, c: int, extrap: bool) -> int:
    """The sequence discriminator's input channels."""
    return (max(t_ctx + 1, t) if extrap else t) * c
