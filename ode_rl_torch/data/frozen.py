"""Frozen Moving MNIST loader.

Counterpart of the ``.npy`` path of ``ode_rl_tpu/data/frozen.py``:
pre-rendered uint8 videos in ``<root>/<split>/shard_*.npy`` (written by
``scripts/make_frozen_mmnist.py``), sampled on the host from
``np.random.RandomState(seed)`` in the JAX loader's order (a random
shard, then a random video and a random window for each batch element),
so that the same corpus and seed give the same batches bit for bit. The
batch ships to the device as float32 in [-0.5, 0.5].

The reference's mp4 layout needs cv2 to decode, which the port does not
use; a corpus of only ``video_*.mp4`` files raises.
"""

from __future__ import annotations

import json
import pathlib
from typing import Iterator, List

import numpy as np
import torch


class FrozenMovingMNIST:
    def __init__(self, root, batch_size: int, n_frames_input: int,
                 n_frames_output: int, is_train: bool = True, seed: int = 0,
                 device: torch.device = torch.device("cpu")):
        self.root = pathlib.Path(root)
        split = "train" if is_train else "test"
        self.shards: List[pathlib.Path] = sorted(
            (self.root / split).glob("shard_*.npy"))
        if not self.shards:
            if any(sorted(d.glob("video_*.mp4"))
                   for d in (self.root / split, self.root) if d.is_dir()):
                raise NotImplementedError(
                    f"{self.root} holds an mp4 corpus: decoding it needs "
                    "cv2, which the port does not use; write .npy shards "
                    "with scripts/make_frozen_mmnist.py")
            raise FileNotFoundError(
                f"no frozen shards under {self.root / split}; run "
                "scripts/make_frozen_mmnist.py first")
        meta_path = self.root / "meta.json"
        self.meta = (json.loads(meta_path.read_text())
                     if meta_path.exists() else {})
        self.batch_size = batch_size
        self.n_total = n_frames_input + n_frames_output
        self.device = device
        self._rng = np.random.RandomState(seed)
        self._cache_path = None
        self._cache = None

    def _shard(self, path: pathlib.Path) -> np.ndarray:
        if self._cache_path != path:
            self._cache = np.load(path, mmap_mode="r")
            self._cache_path = path
        return self._cache

    def __iter__(self) -> Iterator[torch.Tensor]:
        return self

    def __next__(self) -> torch.Tensor:
        """The next batch, (B, T, H, W, 1) float32 in [-0.5, 0.5]."""
        shard = self._shard(self.shards[self._rng.randint(len(self.shards))])
        n_videos, n_frames = shard.shape[:2]
        if n_frames < self.n_total:
            raise ValueError(f"{self.root}: videos of {n_frames} frames, "
                             f"windows of {self.n_total} asked for")
        vids = self._rng.randint(0, n_videos, self.batch_size)
        starts = self._rng.randint(0, n_frames - self.n_total + 1,
                                   self.batch_size)
        batch = np.stack([shard[v, s:s + self.n_total]
                          for v, s in zip(vids, starts)])
        video = batch.astype(np.float32)[..., None] / 255.0 - 0.5
        return torch.from_numpy(video).to(self.device)
