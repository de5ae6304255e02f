"""Digit sprite bank for the Moving MNIST generator.

Counterpart of ``ode_rl_tpu/data/sprites.py``, in numpy: real 28x28 MNIST
digits from ``<data_dir>/train-images-idx3-ubyte.gz`` where that file
exists, else a deterministic procedural bank of digit glyphs (bitmap font
-> upscale -> smooth -> jitter), compact bright sprites on black with
values 0-255.
"""

from __future__ import annotations

import gzip
import os
import pathlib
from typing import Optional

import numpy as np

# Classic 5x7 digit bitmaps.
_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11110", "00001", "00001", "01110", "00001", "00001", "11110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}

DIGIT_SIZE = 28


def _render_glyph(digit: int) -> np.ndarray:
    """Render one 5x7 bitmap into a 28x28 float array in [0, 1]."""
    bitmap = np.array(
        [[int(ch) for ch in row] for row in _FONT[digit]], dtype=np.float32)
    up = np.kron(bitmap, np.ones((3, 3), dtype=np.float32))  # (21, 15)
    canvas = np.zeros((DIGIT_SIZE, DIGIT_SIZE), dtype=np.float32)
    top = (DIGIT_SIZE - up.shape[0]) // 2
    left = (DIGIT_SIZE - up.shape[1]) // 2
    canvas[top:top + up.shape[0], left:left + up.shape[1]] = up
    return canvas


def _smooth(img: np.ndarray, passes: int = 1) -> np.ndarray:
    """Separable 3-tap box blur (keeps strokes MNIST-soft)."""
    k = np.array([0.25, 0.5, 0.25], dtype=np.float32)
    out = img
    for _ in range(passes):
        out = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 0, out)
        out = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 1, out)
    return out


def _procedural_bank(n_variants_per_digit: int = 20,
                     seed: int = 0) -> np.ndarray:
    """Deterministic bank of (10 * n_variants, 28, 28) uint8 sprites."""
    rng = np.random.RandomState(seed)
    sprites = []
    for digit in range(10):
        base = _render_glyph(digit)
        for _ in range(n_variants_per_digit):
            dy, dx = rng.randint(-2, 3, size=2)
            shifted = np.roll(np.roll(base, dy, axis=0), dx, axis=1)
            thickness = rng.uniform(0.9, 1.4)
            img = _smooth(shifted, passes=rng.randint(1, 3)) * thickness
            sprites.append(np.clip(img, 0.0, 1.0))
    bank = np.stack(sprites).astype(np.float32) * 255.0
    return bank.astype(np.uint8)


def load_mnist_idx(path: os.PathLike) -> np.ndarray:
    """Read an IDX image file of 28x28 digits."""
    with gzip.open(path, "rb") as f:
        raw = np.frombuffer(f.read(), np.uint8, offset=16)
    return raw.reshape(-1, DIGIT_SIZE, DIGIT_SIZE)


def get_sprite_bank(data_dir: Optional[os.PathLike] = None,
                    max_sprites: int = 2048, seed: int = 0) -> np.ndarray:
    """A (N, 28, 28) uint8 sprite bank: real MNIST where
    ``<data_dir>/train-images-idx3-ubyte.gz`` exists, else procedural."""
    if data_dir is not None:
        path = pathlib.Path(data_dir) / "train-images-idx3-ubyte.gz"
        if path.exists():
            return load_mnist_idx(path)[:max_sprites]
    return _procedural_bank(seed=seed)
