"""On-device Moving MNIST generation.

Counterpart of ``ode_rl_tpu/data/mmnist.py``: digits bounce in a 64x64
canvas with step length 0.1, are placed on integer pixels and composited
with max, and the position is stepped before the first recorded frame.
Bounces are the closed-form triangle wave. Motion draws (x0, y0, theta,
sprite index) come from an explicit ``torch.Generator``; placement is an
index-put of each 28x28 sprite at its integer offset.
"""

from __future__ import annotations

import math

import torch

from ode_rl_torch.data.sprites import DIGIT_SIZE

IMAGE_SIZE = 64
STEP_LENGTH = 0.1
_CANVAS = IMAGE_SIZE - DIGIT_SIZE  # 36


def _reflect01(x: torch.Tensor) -> torch.Tensor:
    """Triangle wave: reflect x into [0, 1] (elastic bounce off both walls)."""
    m = torch.remainder(x, 2.0)
    return 1.0 - torch.abs(m - 1.0)


def _trajectories(x0: torch.Tensor, y0: torch.Tensor, theta: torch.Tensor,
                  n_frames: int) -> torch.Tensor:
    """Pixel positions (N, n_frames, 2) int32, (top, left), for N digits
    starting at (x0, y0) in [0, 1) and moving at angle theta."""
    v = torch.stack([torch.sin(theta), torch.cos(theta)], dim=-1)  # (vy, vx)
    t = torch.arange(1, n_frames + 1, dtype=torch.float32,
                     device=x0.device)[None, :, None]     # step first
    start = torch.stack([y0, x0], dim=-1)[:, None, :]
    pos = _reflect01(start + v[:, None, :] * t * STEP_LENGTH)
    return (pos * _CANVAS).to(torch.int32)   # truncation, like astype


def _place_all(sprites: torch.Tensor, tops: torch.Tensor,
               lefts: torch.Tensor) -> torch.Tensor:
    """(P, 28, 28) sprites at (P,) integer offsets -> (P, 64, 64)."""
    p = sprites.shape[0]
    span = torch.arange(DIGIT_SIZE, device=sprites.device)
    rows = (tops.long()[:, None] + span)[:, :, None]           # (P, 28, 1)
    cols = (lefts.long()[:, None] + span)[:, None, :]          # (P, 1, 28)
    canvas = sprites.new_zeros((p, IMAGE_SIZE, IMAGE_SIZE))
    canvas[torch.arange(p, device=sprites.device)[:, None, None],
           rows, cols] = sprites
    return canvas


def render_per_digit(sprite_bank: torch.Tensor, idx: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """Per-digit canvases (B, D, T, 64, 64) in [0, 255], before the
    max-composite, from sprite indices (B, D) and positions (B, D, T, 2)."""
    b, d, t, _ = pos.shape
    sprites = sprite_bank.float()[idx.reshape(-1).long()]      # (B·D, 28, 28)
    sprites = sprites[:, None].expand(b * d, t, DIGIT_SIZE, DIGIT_SIZE)
    flat_pos = pos.reshape(b * d * t, 2)
    placed = _place_all(sprites.reshape(-1, DIGIT_SIZE, DIGIT_SIZE),
                        flat_pos[:, 0], flat_pos[:, 1])
    return placed.reshape(b, d, t, IMAGE_SIZE, IMAGE_SIZE)


def render_moving_mnist(sprite_bank: torch.Tensor, idx: torch.Tensor,
                        pos: torch.Tensor) -> torch.Tensor:
    """Video (B, T, 64, 64, 1) in [-0.5, 0.5] from sprite indices (B, D)
    and positions (B, D, T, 2)."""
    video = render_per_digit(sprite_bank, idx, pos).amax(dim=1)
    return torch.clamp(video[..., None] / 255.0 - 0.5, -0.5, 0.5)


def draw_digits(generator: torch.Generator, sprite_bank: torch.Tensor,
                batch: int, n_frames: int, num_digits: int):
    """The random draws of one batch, made on the sprite bank's device:
    sprite indices (batch, num_digits) and positions (batch, num_digits,
    n_frames, 2) int32 (top, left)."""
    device = sprite_bank.device
    bd = batch * num_digits
    draw = lambda: torch.rand(bd, generator=generator, device=device)
    x0, y0 = draw(), draw()
    theta = draw() * 2.0 * math.pi
    idx = torch.randint(0, sprite_bank.shape[0], (bd,), generator=generator,
                        device=device)
    pos = _trajectories(x0, y0, theta, n_frames)
    return (idx.reshape(batch, num_digits),
            pos.reshape(batch, num_digits, n_frames, 2))


def generate_moving_mnist(generator: torch.Generator,
                          sprite_bank: torch.Tensor, batch: int,
                          n_frames: int, num_digits: int = 2) -> torch.Tensor:
    """(batch, n_frames, 64, 64, 1) float32 video in [-0.5, 0.5], made on
    the generator's device."""
    idx, pos = draw_digits(generator, sprite_bank, batch, n_frames,
                           num_digits)
    return render_moving_mnist(sprite_bank, idx, pos)


def generate_moving_mnist_per_digit(generator: torch.Generator,
                                    sprite_bank: torch.Tensor, batch: int,
                                    n_frames: int, num_digits: int = 3):
    """Per-digit canvases before the max-composite: (per_digit (B, D, T,
    64, 64) float32 in [0, 255], sprite_idx (B, D), positions (B, D, T, 2)
    int32). The flow generator needs each pixel's front digit."""
    idx, pos = draw_digits(generator, sprite_bank, batch, n_frames,
                           num_digits)
    return render_per_digit(sprite_bank, idx, pos), idx, pos
