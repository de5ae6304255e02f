"""Frozen Moving MNIST loader.

Counterpart of ``ode_rl_tpu/data/frozen.py``, with its two on-disk
layouts:

  * pre-rendered uint8 videos in ``<root>/<split>/shard_*.npy`` (written
    by ``python -m ode_rl_torch.make_frozen_mmnist``);
  * the reference's own layout, a directory of ``video_<n>.mp4`` files
    (written by ``python -m ode_rl_torch.make_mp4_mmnist``) under
    ``<root>/<split>/``, or flat under ``<root>`` for both splits. They
    are decoded once with cv2, with the reference's bounded read-retry
    loop, to gray frames in ``sorted(glob)`` order (so ``video_10`` comes
    before ``video_2``), each cut to the shortest video's length, and
    held in memory as one shard. cv2 is imported only to decode.

Batches are sampled on the host from ``np.random.RandomState(seed)`` in
the JAX loader's order (a random shard, which the mp4 layout does not
draw, then a random video and a random window for each batch element),
so that the same corpus and seed give the same batches bit for bit. The
batch ships to the device as float32 in [-0.5, 0.5].
"""

from __future__ import annotations

import json
import pathlib
from typing import Iterator, List, Optional

import numpy as np
import torch


def read_video_file(path, retries: int = 10, gray: bool = True) -> np.ndarray:
    """Decode a video file to (T, H, W) uint8 (gray) or (T, H, W, 3) RGB,
    opening it again while a read yields no frame, up to ``retries``
    times, then raising ``IOError``."""
    import cv2

    last = 0
    for _ in range(retries):
        cap = cv2.VideoCapture(str(path))
        frames = []
        while True:
            ok, img = cap.read()
            if not ok:
                break
            code = cv2.COLOR_BGR2GRAY if gray else cv2.COLOR_BGR2RGB
            frames.append(cv2.cvtColor(img, code).astype(np.uint8))
        cap.release()
        if frames and len(frames) >= last:
            return np.stack(frames)
        last = len(frames)
    raise IOError(f"failed to decode {path} after {retries} attempts")


def _load_mp4_corpus(split_dir: pathlib.Path) -> np.ndarray:
    """Every ``video_*.mp4`` under ``split_dir`` decoded into one
    (n_videos, n_frames, H, W) uint8 shard, cut to the shortest video."""
    decoded = [read_video_file(p)
               for p in sorted(split_dir.glob("video_*.mp4"))]
    t_min = min(v.shape[0] for v in decoded)
    return np.stack([v[:t_min] for v in decoded])


class FrozenMovingMNIST:
    def __init__(self, root, batch_size: int, n_frames_input: int,
                 n_frames_output: int, is_train: bool = True, seed: int = 0,
                 device: torch.device = torch.device("cpu")):
        self.root = pathlib.Path(root)
        split = "train" if is_train else "test"
        self.shards: List[pathlib.Path] = sorted(
            (self.root / split).glob("shard_*.npy"))
        self._mp4_shard: Optional[np.ndarray] = None
        if not self.shards:
            for cand in (self.root / split, self.root):
                if sorted(cand.glob("video_*.mp4")):
                    self._mp4_shard = _load_mp4_corpus(cand)
                    break
            else:
                raise FileNotFoundError(
                    f"no frozen shards under {self.root / split} and no "
                    f"video_*.mp4 corpus under {self.root}; run python -m "
                    "ode_rl_torch.make_frozen_mmnist or python -m "
                    "ode_rl_torch.make_mp4_mmnist first")
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
        shard = (self._mp4_shard if self._mp4_shard is not None else
                 self._shard(self.shards[self._rng.randint(len(self.shards))]))
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
