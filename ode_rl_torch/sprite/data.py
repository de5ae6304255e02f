"""Sprites: the labelled clips a ``.npy`` corpus holds, else procedural
ones.

Counterpart of ``ode_rl_tpu/sprite/data.py``. ``render_sprites`` draws
each video from its (color, action, phase) as JAX's ``sprites_batch``
does: an 11x11 square of one of six colours inside a 15x15 sprite,
moved right, down, diagonally (10 + 4t) or on a circle (24 + 16 cos/sin
of phase + t) in fp32, truncated to int32, clipped to [0, 49] and
placed on a black 64x64 canvas. ``sprites_batch`` draws the labels from
an explicit generator (the draws are not JAX's). ``SpritesLoader`` reads
``sprites_clips.npy`` (N, T, 64, 64, 3) in [0, 1] and
``sprites_labels.npy`` (N, 2: action, colour) from ``data_dir`` where
both exist, in order, else makes batches.
"""

from __future__ import annotations

import math
import pathlib
from typing import Optional, Tuple

import numpy as np
import torch

from ode_rl_torch.core.noise import Noise

N_ACTIONS = 4    # right, down, diagonal, circle
N_COLORS = 6
SPRITE, CANVAS = 15, 64
PALETTE = np.array([
    [1.0, 0.2, 0.2], [0.2, 1.0, 0.2], [0.2, 0.4, 1.0],
    [1.0, 1.0, 0.2], [1.0, 0.2, 1.0], [0.2, 1.0, 1.0],
], dtype=np.float32)


def sprite_bank() -> np.ndarray:
    """(N_COLORS, 15, 15, 3): one 11x11 coloured square each."""
    bank = np.zeros((N_COLORS, SPRITE, SPRITE, 3), np.float32)
    bank[:, 2:13, 2:13] = PALETTE[:, None, None]
    return bank


def render_sprites(colors: torch.Tensor, actions: torch.Tensor,
                   phase: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B,) colours, actions and fp32 phases -> (B, n_frames, 64, 64, 3)
    in [0, 1]."""
    device = phase.device
    b = phase.shape[0]
    t = torch.arange(n_frames, dtype=torch.float32, device=device)
    lin = (10.0 + 4.0 * t).expand(b, n_frames)
    mid = torch.full_like(lin, 24.0)
    arg = phase.float()[:, None] + t
    xs = torch.stack([lin, mid, lin, 24.0 + 16.0 * torch.cos(arg)], dim=1)
    ys = torch.stack([mid, lin, lin, 24.0 + 16.0 * torch.sin(arg)], dim=1)
    pick = actions.long()[:, None, None].expand(b, 1, n_frames)
    top = torch.clamp(ys.gather(1, pick)[:, 0].to(torch.int32), 0,
                      CANVAS - SPRITE).long()
    left = torch.clamp(xs.gather(1, pick)[:, 0].to(torch.int32), 0,
                       CANVAS - SPRITE).long()
    span = torch.arange(SPRITE, device=device)
    video = torch.zeros((b, n_frames, CANVAS, CANVAS, 3), device=device)
    bank = torch.from_numpy(sprite_bank()).to(device)
    video[torch.arange(b, device=device)[:, None, None, None],
          torch.arange(n_frames, device=device)[None, :, None, None],
          (top[:, :, None] + span)[..., None],
          (left[:, :, None] + span)[:, :, None, :]] = bank[
              colors.long()][:, None]
    return video


def sprites_batch(noise: Noise, batch: int, n_frames: int = 8,
                  device: Optional[torch.device] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (video (B, T, 64, 64, 3) in [-0.5, 0.5], action (B,), colour
    (B,)), the labels drawn from ``noise`` in JAX's order (colour,
    action, phase)."""
    device = device or noise.generator.device
    colors = noise.randint(0, N_COLORS, (batch,), device)
    actions = noise.randint(0, N_ACTIONS, (batch,), device)
    phase = noise.uniform((batch,), device) * (2 * math.pi)
    video = render_sprites(colors, actions, phase, n_frames)
    return video - 0.5, actions, colors


class SpritesLoader:
    """Infinite labelled stream of (video, action, colour) batches."""

    def __init__(self, batch_size: int, n_frames: int = 8,
                 data_dir: Optional[str] = None, seed: int = 0,
                 device: torch.device = torch.device("cpu")):
        self.batch_size, self.n_frames, self.device = (batch_size, n_frames,
                                                       device)
        self._real = None
        if data_dir is not None:
            path = pathlib.Path(data_dir)
            clips, labels = (path / "sprites_clips.npy",
                             path / "sprites_labels.npy")
            if clips.exists() and labels.exists():
                self._real = (np.load(clips), np.load(labels))
        self._noise = Noise(torch.Generator(device=device).manual_seed(seed))
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._real is not None:
            clips, labels = self._real
            idx = (np.arange(self.batch_size) + self._pos) % len(clips)
            self._pos += self.batch_size
            video = torch.from_numpy(clips[idx].astype(np.float32)).to(
                self.device) - 0.5
            lab = torch.from_numpy(labels[idx]).to(self.device)
            return video, lab[..., 0], lab[..., 1]
        return sprites_batch(self._noise, self.batch_size, self.n_frames,
                             self.device)
