"""Per-video ``.npy`` corpora: the Vid-ODE datasets.

Counterpart of ``ode_rl_tpu/data/video_corpus.py``: uint8 videos (T, H,
W[, C]) one a file under ``<root>/{train,test}/``, with a transform spec
for each dataset (``DATASET_SPECS``: mgif and penn scaled to 128, kth
center-cropped to 120 then scaled to ``resolution``, phyre and minerl to
64, hurricane's six channels padded by one pixel left and right,
mmnist_video at 64), videos shorter than the window dropped, and in
training a random horizontal flip and a rotation of up to 10 degrees a
clip where the spec augments. Batches are float32 in [-0.5, 0.5] on the
loader's device: ``window_size``-frame clips that the window samplers
(data/samplers.py) then sample and split.

Files and window starts are picked on the host from
``np.random.RandomState(seed)`` in the JAX loader's order, so the same
corpus and seed read the same clips; the augmentation's draws (a flip
uniform, then an angle, for each clip of the batch) come from a
``torch.Generator`` seeded with ``seed`` (train) or ``seed + 7`` (test),
where JAX uses its PRNG.

``write_synthetic_corpus`` writes a stand-in corpus in that layout (the
datasets are not in the repo): moving Gaussian blobs at each dataset's
raw geometry, with numpy alone; ``write_phyre_corpus`` writes synthetic
PHYRE rollouts. Both write the bytes of the JAX repo's scripts
(``scripts/make_synthetic_corpus.py``, ``scripts/generate_phyre_dataset.py
--synthetic``) at the same seed; the port's commands
``make_synthetic_corpus`` and ``generate_phyre_dataset`` run them.
"""

from __future__ import annotations

import hashlib
import math
import pathlib
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ode_rl_torch.core.noise import Noise
from ode_rl_torch.data import video_transforms as vt
from ode_rl_torch.ops.warp import grid_sample

# size: the final square resolution (None: cfg.resolution); crop: a
# center crop before scaling; pad_lr: pixels of padding left and right;
# channels: the channels kept; augment: the training-time flip and
# rotation.
DATASET_SPECS: Dict[str, Dict] = {
    "mgif": dict(size=128, crop=None, pad_lr=0, channels=3, augment=True),
    "kth": dict(size=None, crop=120, pad_lr=0, channels=1, augment=True),
    "penn": dict(size=128, crop=None, pad_lr=0, channels=3, augment=True),
    "phyre": dict(size=64, crop=None, pad_lr=0, channels=3, augment=True),
    "minerl": dict(size=64, crop=None, pad_lr=0, channels=3, augment=True),
    "hurricane": dict(size=None, crop=None, pad_lr=1, channels=6,
                      augment=False),
    "mmnist_video": dict(size=64, crop=None, pad_lr=0, channels=1,
                         augment=False),
}


def corpus_datasets() -> List[str]:
    return sorted(DATASET_SPECS)


def transform_batch(noise: Noise, clips: torch.Tensor, dataset: str,
                    size: int, train: bool) -> torch.Tensor:
    """uint8 (B, T, H, W, C) -> float32 [-0.5, 0.5] at (size, size)."""
    spec = DATASET_SPECS[dataset]
    b, t = clips.shape[:2]
    x = clips.float() / 255.0
    x = x.reshape(b * t, *x.shape[2:])
    if spec["pad_lr"]:
        p = spec["pad_lr"]
        x = F.pad(x, (0, 0, p, p))
    if spec["crop"]:
        x = vt.center_crop(x, (spec["crop"], spec["crop"]))
    if x.shape[1] != size or x.shape[2] != size:
        x = vt.scale(x, (size, size))
    x = x.reshape(b, t, *x.shape[1:])
    if train and spec["augment"]:
        flip = noise.uniform((b,), x.device) < 0.5
        x = torch.where(flip[:, None, None, None, None], x.flip(3), x)
        angle = noise.uniform((b,), x.device, -10.0, 10.0)
        grid = vt.rotation_grid(angle * math.pi / 180.0, size, size)
        grid = grid[:, None].expand(b, t, size, size, 2)
        x = grid_sample(x.reshape(b * t, size, size, -1),
                        grid.reshape(b * t, size, size, 2)).reshape(x.shape)
    return x - 0.5


class VideoCorpus:
    """Iterator over batches of ``clip_len``-frame clips of a corpus."""

    def __init__(self, root, dataset: str, batch_size: int, clip_len: int,
                 is_train: bool = True, resolution: int = 64,
                 seed: int = 0,
                 device: torch.device = torch.device("cpu")):
        if dataset not in DATASET_SPECS:
            raise NotImplementedError(
                f"There is no dataset named {dataset} "
                f"(video corpora: {corpus_datasets()})")
        self.dataset = dataset
        self.spec = DATASET_SPECS[dataset]
        self.size = int(self.spec["size"] or resolution)
        self.batch_size, self.clip_len = batch_size, clip_len
        self.train = is_train
        self.device = device
        split = "train" if is_train else "test"
        self.root = pathlib.Path(root) / split
        files = sorted(self.root.glob("*.npy"))
        if not files:
            raise FileNotFoundError(
                f"no .npy videos under {self.root}; write a stand-in "
                "corpus with python -m ode_rl_torch.make_synthetic_corpus "
                "or python -m ode_rl_torch.generate_phyre_dataset, or "
                "convert real videos with scripts/convert_mp4_to_npy.py")
        # Videos shorter than the window are dropped.
        self.files = [f for f in files
                      if np.load(f, mmap_mode="r").shape[0] >= clip_len]
        dropped = len(files) - len(self.files)
        if dropped:
            print(f"{dataset}/{split}: removed {dropped:03d} videos shorter "
                  f"than {clip_len} frames")
        if not self.files:
            raise ValueError(f"all videos under {self.root} are shorter "
                             f"than clip_len={clip_len}")
        self._rng = np.random.RandomState(seed)
        self._noise = Noise(torch.Generator().manual_seed(
            seed + (0 if is_train else 7)))
        self._cursor = 0

    def __len__(self) -> int:
        return max(len(self.files) // self.batch_size, 1)

    def __iter__(self) -> Iterator[torch.Tensor]:
        return self

    def _pick_files(self) -> List[pathlib.Path]:
        if self.train:
            idx = self._rng.randint(0, len(self.files), self.batch_size)
        else:  # a deterministic sweep
            idx = [(self._cursor + i) % len(self.files)
                   for i in range(self.batch_size)]
            self._cursor = (self._cursor + self.batch_size) % len(self.files)
        return [self.files[i] for i in idx]

    def __next__(self) -> torch.Tensor:
        clips = []
        c = self.spec["channels"]
        for f in self._pick_files():
            video = np.load(f, mmap_mode="r")
            start = (self._rng.randint(0, video.shape[0] - self.clip_len + 1)
                     if self.train else 0)
            clip = np.asarray(video[start:start + self.clip_len])
            if clip.ndim == 3:
                clip = clip[..., None]
            if clip.shape[-1] < c:
                clip = np.repeat(clip, c, axis=-1)[..., :c]
            clips.append(clip[..., :c])
        batch = torch.from_numpy(np.stack(clips)).to(self.device)
        return transform_batch(self._noise, batch, self.dataset, self.size,
                               self.train and self.spec["augment"])


def parse_video_corpus(cfg, device: torch.device) -> Dict:
    """The loaders of a Vid-ODE corpus: ``window_size``-frame clips (or
    ``train_seq``/``test_seq``), the test loader's ``test_seq`` in the
    test phase; ``data_dir`` is the corpus or its parent."""
    phase = cfg.get("phase", "train")
    clip_len = int(cfg.get("window_size", 0)) or int(
        cfg.train_seq if phase == "train" else cfg.test_seq)
    root = pathlib.Path(str(cfg.get("data_dir", "datasets")))
    if not (root / "train").exists() and (root / cfg.dataset
                                          / "train").exists():
        root = root / cfg.dataset
    test_len = (int(cfg.get("test_seq", clip_len)) if phase == "test"
                else clip_len)
    mk = lambda train: VideoCorpus(
        root, cfg.dataset, batch_size=cfg.batch_size,
        clip_len=clip_len if train else test_len, is_train=train,
        resolution=int(cfg.get("resolution", 64)),
        seed=cfg.get("seed", 0), device=device)
    train_loader, test_loader = mk(True), mk(False)
    return {"train_dataloader": train_loader,
            "test_dataloader": test_loader,
            "n_train_batches": len(train_loader),
            "n_test_batches": len(test_loader), "frozen": True}


# Raw geometry of each dataset's videos: (H, W, C, shortest, longest).
RAW_SPECS = {
    "kth": (120, 160, 1, 40, 120),
    "mgif": (128, 128, 3, 12, 60),
    "penn": (160, 160, 3, 30, 90),
    "phyre": (64, 64, 3, 40, 40),
    "minerl": (64, 64, 3, 100, 100),
    "hurricane": (65, 63, 6, 30, 60),
}


def _blob_video(rng: np.random.RandomState, h: int, w: int, c: int,
                t: int) -> np.ndarray:
    """1-3 Gaussian blobs bouncing at constant velocity; each channel
    mixes them with its own gains. The draws and the arithmetic are
    ``scripts/make_synthetic_corpus.py::render_video``'s: the blob canvas
    is float32 (a float64 one moves the uint8 truncation of a pixel now
    and then), so the bytes are the script's."""
    n = rng.randint(1, 4)
    pos = rng.rand(n, 2) * [h - 16, w - 16] + 8
    vel = (rng.rand(n, 2) - 0.5) * 6
    radius = rng.randint(5, 12, n)
    gains = 0.5 + rng.rand(c, n)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.zeros((t, h, w, c), np.uint8)
    lim = np.array([h - 8, w - 8])
    for ti in range(t):
        canvas = np.zeros((h, w, n), np.float32)
        for i in range(n):
            d2 = (yy - pos[i, 0]) ** 2 + (xx - pos[i, 1]) ** 2
            canvas[..., i] = np.exp(-d2 / (2 * radius[i] ** 2))
        img = np.einsum("hwn,cn->hwc", canvas, gains)
        frames[ti] = np.clip(img * 255, 0, 255).astype(np.uint8)
        pos += vel
        out = (pos < 8) | (pos > lim)
        vel[out] *= -1
        pos = np.clip(pos, 8, lim)
    return frames


# PHYRE's palette: red, green, blue and gray balls on white.
PHYRE_COLORS = np.array([[220, 40, 40], [40, 160, 60], [50, 80, 220],
                         [120, 120, 120]], np.float32)
PHYRE_GRAVITY = 0.6


def phyre_rollout(rng: np.random.RandomState, t: int = 40,
                  size: int = 64) -> np.ndarray:
    """A synthetic PHYRE rollout, uint8 (t, size, size, 3): 1-3 balls
    under gravity, bouncing off the floor (restitution 0.8) and the side
    walls, drawn in PHYRE's palette on white. The draws and the
    arithmetic are ``scripts/generate_phyre_dataset.py::synthetic_rollout``'s,
    so the bytes are the script's."""
    n = rng.randint(1, 4)
    pos = rng.rand(n, 2) * [size * 0.4, size - 12] + [4, 6]
    vel = (rng.rand(n, 2) - 0.5) * [2, 6]
    radius = rng.randint(3, 7, n)
    colors = PHYRE_COLORS[rng.randint(0, 4, n)]
    yy, xx = np.mgrid[0:size, 0:size]
    frames = np.empty((t, size, size, 3), np.uint8)
    for ti in range(t):
        img = np.full((size, size, 3), 255, np.float32)
        for i in range(n):
            d2 = (yy - pos[i, 0]) ** 2 + (xx - pos[i, 1]) ** 2
            img = np.where((d2 <= radius[i] ** 2)[..., None], colors[i], img)
        frames[ti] = img.astype(np.uint8)
        vel[:, 0] += PHYRE_GRAVITY
        pos += vel
        for i in range(n):
            lim = size - radius[i] - 1
            if pos[i, 0] > lim:
                pos[i, 0] = lim
                vel[i, 0] *= -0.8
            if pos[i, 1] < radius[i] or pos[i, 1] > lim:
                vel[i, 1] *= -1
                pos[i, 1] = np.clip(pos[i, 1], radius[i], lim)
    return frames


def write_synthetic_corpus(root, dataset: str, train_videos: int = 8,
                           test_videos: int = 4, seed: int = 0,
                           frames: Optional[int] = None) -> pathlib.Path:
    """Write ``<root>/{train,test}/video_*.npy`` for ``dataset`` (uint8,
    (T, H, W, C) at its raw geometry; ``frames`` fixes T, else each
    video's length is drawn in the dataset's range). Returns root."""
    h, w, c, tmin, tmax = RAW_SPECS[dataset]
    root = pathlib.Path(root)
    rng = np.random.RandomState(seed)
    for split, count in (("train", train_videos), ("test", test_videos)):
        d = root / split
        d.mkdir(parents=True, exist_ok=True)
        for i in range(count):
            t = frames or int(rng.randint(tmin, tmax + 1))
            np.save(d / f"video_{i:05d}.npy", _blob_video(rng, h, w, c, t))
    return root


def write_phyre_corpus(root, train_videos: int = 40, test_videos: int = 8,
                       frames: int = 40, seed: int = 0) -> pathlib.Path:
    """Write ``<root>/{train,test}/rollout_*.npy``: ``phyre_rollout``s of
    ``frames`` frames. Returns root."""
    root = pathlib.Path(root)
    rng = np.random.RandomState(seed)
    for split, count in (("train", train_videos), ("test", test_videos)):
        d = root / split
        d.mkdir(parents=True, exist_ok=True)
        for i in range(count):
            np.save(d / f"rollout_{i:05d}.npy", phyre_rollout(rng, t=frames))
    return root


def corpus_sha256(root) -> Dict[str, str]:
    """{'<split>/<file>.npy': sha256} of every video of a corpus."""
    root = pathlib.Path(root)
    return {f"{split}/{f.name}": hashlib.sha256(f.read_bytes()).hexdigest()
            for split in ("train", "test")
            for f in sorted((root / split).glob("*.npy"))}
