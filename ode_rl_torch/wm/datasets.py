"""Dreamer episode batches.

Counterpart of ``ode_rl_tpu/wm/datasets.py``: long Moving MNIST episodes
made on the device are split into ``batch_length`` chunks folded into
the batch axis for world-model training.

JAX's ``EpisodeLoader`` makes ``max(1, batch_size // (episode_length //
batch_length))`` episodes a batch, so where ``batch_size`` is not a
multiple of the chunks an episode gives, a batch has fewer rows than
``batch_size`` (batch 6 at 200/50: 4 rows). The port keeps that fault,
so that both give the same batches; it is to be fixed in both packages
at once. JAX folds its process index into the key; the port's one
process seeds its generator with ``seed``.
"""

from __future__ import annotations

from typing import Dict, Iterator

import torch

from ode_rl_torch.data.mmnist import generate_moving_mnist
from ode_rl_torch.data.sprites import get_sprite_bank


def break_batch(video: torch.Tensor, batch_length: int) -> torch.Tensor:
    """(B, T, ...) -> (B * (T // L), L, ...): episode chunks folded into
    the batch, the remainder frames dropped."""
    b, t = video.shape[:2]
    n = t // batch_length
    return video[:, : n * batch_length].reshape(
        b * n, batch_length, *video.shape[2:])


class EpisodeLoader:
    """Infinite stream of {'image': (rows, batch_length, 64, 64, 1)} in
    [-0.5, 0.5], made on ``device``."""

    def __init__(self, batch_size: int, episode_length: int = 200,
                 batch_length: int = 50, num_digits: int = 2,
                 seed: int = 0, device: torch.device = torch.device("cpu")):
        self.batch_size = batch_size
        self.episode_length = episode_length
        self.batch_length = batch_length
        self.num_digits = num_digits
        self.bank = torch.from_numpy(get_sprite_bank()).float().to(device)
        self._gen = torch.Generator(device=device).manual_seed(seed)
        self._episodes = max(
            1, batch_size // max(episode_length // batch_length, 1))

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        video = generate_moving_mnist(
            self._gen, self.bank, batch=self._episodes,
            n_frames=self.episode_length, num_digits=self.num_digits)
        chunks = break_batch(video, self.batch_length)
        return {"image": chunks[: self.batch_size]}
