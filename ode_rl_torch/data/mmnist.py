"""On-device Moving MNIST generation, and the datasets of a run.

Counterpart of ``ode_rl_tpu/data/mmnist.py``: digits bounce in a 64x64
canvas with step length 0.1, are placed on integer pixels and composited
with max, and the position is stepped before the first recorded frame.
Bounces are the closed-form triangle wave. Motion draws (x0, y0, theta,
sprite index) come from an explicit ``torch.Generator``; placement is an
index-put of each 28x28 sprite at its integer offset.

``parse_datasets`` builds a run's train and test loaders: for ``dataset:
sprites`` the Sprites clips (sprite/data.py); for ``dataset:
mmnist`` the frozen corpus (data/frozen.py) where ``frozen`` is on and
``data_dir`` holds ``meta.json`` or an mp4 corpus (``video_*.mp4``), else
the generator; for the Vid-ODE corpora (kth, mgif, penn, hurricane,
phyre, minerl, mmnist_video) the per-video corpus of
data/video_corpus.py. Any other dataset raises, as in JAX: the CATER
blocks' ``dataset: cater`` never reaches here (wm/cater.py reads its
corpus).
"""

from __future__ import annotations

import math
import pathlib
from typing import Iterator

import torch

from ode_rl_torch.data.frozen import FrozenMovingMNIST
from ode_rl_torch.data.sprites import DIGIT_SIZE, get_sprite_bank
from ode_rl_torch.data.video_corpus import DATASET_SPECS, parse_video_corpus
from ode_rl_torch.sprite.data import SpritesLoader

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


def generate_moving_mnist_labeled(generator: torch.Generator,
                                  sprite_bank: torch.Tensor, batch: int,
                                  n_frames: int, num_digits: int = 1):
    """The labelled batch of the disentanglement probes: (video (B, T,
    64, 64, 1) in [-0.5, 0.5], sprite_idx (B, D), positions (B, D, T, 2)
    int32), all from the same draws. The sprite is the content factor,
    the trajectory the motion factor."""
    idx, pos = draw_digits(generator, sprite_bank, batch, n_frames,
                           num_digits)
    return render_moving_mnist(sprite_bank, idx, pos), idx, pos


def generate_moving_mnist_per_digit(generator: torch.Generator,
                                    sprite_bank: torch.Tensor, batch: int,
                                    n_frames: int, num_digits: int = 3):
    """Per-digit canvases before the max-composite: (per_digit (B, D, T,
    64, 64) float32 in [0, 255], sprite_idx (B, D), positions (B, D, T, 2)
    int32). The flow generator needs each pixel's front digit."""
    idx, pos = draw_digits(generator, sprite_bank, batch, n_frames,
                           num_digits)
    return render_per_digit(sprite_bank, idx, pos), idx, pos


# The test stream's seed offset (ode_rl_tpu/data/mmnist.py, MovingMNIST).
TEST_SEED_OFFSET = 77_000_003


class MovingMNIST:
    """Infinite iterator over Moving MNIST batches generated on
    ``device`` from a ``torch.Generator`` seeded with ``seed`` (train) or
    ``seed + TEST_SEED_OFFSET`` (test)."""

    def __init__(self, batch_size: int, n_frames_input: int,
                 n_frames_output: int, num_digits: int = 2,
                 data_dir=None, seed: int = 0, is_train: bool = True,
                 num_sprites: int = 0,
                 device: torch.device = torch.device("cpu")):
        self.batch_size = batch_size
        self.n_frames_total = n_frames_input + n_frames_output
        self.num_digits = num_digits
        bank = get_sprite_bank(data_dir)
        if num_sprites:
            bank = bank[:num_sprites]
        self.sprite_bank = torch.from_numpy(bank).float().to(device)
        self._gen = torch.Generator(device=device).manual_seed(
            seed if is_train else seed + TEST_SEED_OFFSET)

    def __iter__(self) -> Iterator[torch.Tensor]:
        return self

    def __next__(self) -> torch.Tensor:
        return generate_moving_mnist(self._gen, self.sprite_bank,
                                     batch=self.batch_size,
                                     n_frames=self.n_frames_total,
                                     num_digits=self.num_digits)


def _parse_sprites(cfg, device: torch.device) -> dict:
    """The Sprites clips (sprite/data.py) of the phase's frames, without
    their labels; the test loader's seed is the train one's plus 99."""
    if cfg.get("phase", "train") == "train":
        n_frames = int(cfg.train_in_seq) + int(cfg.train_out_seq)
    else:
        n_frames = int(cfg.test_in_seq) + int(cfg.test_out_seq)
    seed = cfg.get("seed", 0)
    mk = lambda s: (video for video, _, _ in SpritesLoader(
        batch_size=cfg.batch_size, n_frames=n_frames,
        data_dir=cfg.get("data_dir"), seed=s, device=device))
    total = int(cfg.get("data_points", 10000))
    n_train = int(cfg.get("train_test_split", 0.8) * total)
    return {"train_dataloader": mk(seed), "test_dataloader": mk(seed + 99),
            "n_train_batches": max(n_train // cfg.batch_size, 1),
            "n_test_batches": max((total - n_train) // cfg.batch_size, 1)}


def parse_datasets(cfg, device: torch.device) -> dict:
    """Train and test loaders and batch counts for ``dataset: mmnist``
    and the Vid-ODE video corpora (the contract of the JAX
    ``parse_datasets``)."""
    if cfg.dataset == "sprites":
        return _parse_sprites(cfg, device)
    if cfg.dataset in DATASET_SPECS:
        return parse_video_corpus(cfg, device)
    if cfg.dataset != "mmnist":
        raise NotImplementedError(f"There is no dataset named {cfg.dataset}")
    total = int(cfg.get("data_points", 10000))
    n_train = int(cfg.get("train_test_split", 0.8) * total)
    counts = {"n_train_batches": max(n_train // cfg.batch_size, 1),
              "n_test_batches": max((total - n_train) // cfg.batch_size, 1)}
    seed = cfg.get("seed", 0)

    # A frozen corpus: .npy shards with meta.json, or the reference's
    # video_*.mp4 files, flat or under train/.
    frozen_root = pathlib.Path(str(cfg.get("data_dir", "")))
    has_mp4 = any(list(d.glob("video_*.mp4"))
                  for d in (frozen_root, frozen_root / "train") if d.is_dir())
    if cfg.get("frozen", False) and ((frozen_root / "meta.json").exists()
                                     or has_mp4):
        mk = lambda train: FrozenMovingMNIST(
            frozen_root, batch_size=cfg.batch_size,
            n_frames_input=cfg.train_in_seq if train else cfg.test_in_seq,
            n_frames_output=(cfg.train_out_seq if train
                             else cfg.test_out_seq),
            is_train=train, seed=seed, device=device)
        return {"train_dataloader": mk(True), "test_dataloader": mk(False),
                **counts, "frozen": True}

    mk = lambda train: MovingMNIST(
        batch_size=cfg.batch_size,
        n_frames_input=cfg.train_in_seq if train else cfg.test_in_seq,
        n_frames_output=cfg.train_out_seq if train else cfg.test_out_seq,
        num_digits=cfg.num_digits, data_dir=cfg.get("data_dir"), seed=seed,
        is_train=train, num_sprites=int(cfg.get("num_sprites", 0) or 0),
        device=device)
    return {"train_dataloader": mk(True), "test_dataloader": mk(False),
            **counts}
