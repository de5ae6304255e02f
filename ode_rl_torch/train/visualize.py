"""Image sheets and per-frame dumps, written as PNG with ``zlib``.

Counterpart of ``save_filmstrip`` and ``dump_pred_gt_pngs`` in
``ode_rl_tpu/train/visualize.py``: frames in [0, 1] clip and scale to
uint8 RGB, videos (T, H, W, C) become the rows of
one sheet with a column a frame (at most ``max_cols``), and a dump writes
``pred_{b}_{t}.png``/``gt_{b}_{t}.png`` a frame. JAX writes with PIL; the
port writes the PNG itself (8-bit RGB, filter 0 on every row, one IDAT),
so it needs neither PIL nor matplotlib. The metric-vs-horizon plot
(matplotlib) is not ported.
"""

from __future__ import annotations

import pathlib
import struct
import zlib
from typing import Sequence

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _to_uint8(frames) -> np.ndarray:
    """[0, 1] float frames -> uint8 RGB: grayscale repeated, channels
    beyond three (hurricane's six fields) dropped, where JAX's PIL
    refuses the image."""
    x = np.clip(np.asarray(frames, np.float32), 0.0, 1.0)
    x = (x * 255.0).astype(np.uint8)
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    return x[..., :3]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, image: np.ndarray) -> pathlib.Path:
    """Write an (H, W, 3) uint8 image."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w, c = image.shape
    if c != 3:
        raise ValueError(f"RGB images only, got {c} channels")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    path = pathlib.Path(path)
    path.write_bytes(_SIGNATURE + _chunk(b"IHDR", header)
                     + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                     + _chunk(b"IEND", b""))
    return path


def save_filmstrip(path, videos: Sequence[np.ndarray],
                   max_cols: int = 20) -> pathlib.Path:
    """Stack (T, H, W, C) videos as the rows of one PNG sheet, a column a
    frame."""
    rows = [np.concatenate(list(_to_uint8(v)[:max_cols]), axis=1)
            for v in videos]
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    return write_png(path, np.concatenate(rows, axis=0))


def dump_pred_gt_pngs(outdir, pred: np.ndarray, gt: np.ndarray) -> int:
    """``pred_{b}_{t}.png`` and ``gt_{b}_{t}.png`` for every frame of
    (B, T, H, W, C) ``pred`` and ``gt``. Returns the files written."""
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    pred8, gt8 = _to_uint8(pred), _to_uint8(gt)
    n = 0
    for b in range(pred8.shape[0]):
        for t in range(pred8.shape[1]):
            write_png(outdir / f"pred_{b}_{t}.png", pred8[b, t])
            write_png(outdir / f"gt_{b}_{t}.png", gt8[b, t])
            n += 2
    return n
