"""Image sheets, per-frame dumps and the metric-vs-horizon plot, written
as PNG with ``zlib``.

Counterpart of ``save_filmstrip``, ``dump_pred_gt_pngs`` and
``plot_metrics_vs_horizon`` in ``ode_rl_tpu/train/visualize.py``: frames
in [0, 1] clip and scale to uint8 RGB, videos (T, H, W, C) become the
rows of one sheet with a column a frame (at most ``max_cols``), a dump
writes ``pred_{b}_{t}.png``/``gt_{b}_{t}.png`` a frame, and the plot
draws one panel a metric (MSE, PSNR, SSIM) over the horizon beside a
JSON of every curve. JAX writes with PIL and plots with matplotlib; the
port writes the PNG itself (8-bit RGB, filter 0 on every row, one IDAT)
and draws the plot with numpy and a bitmap font of its own, so it needs
neither PIL nor matplotlib.
"""

from __future__ import annotations

import json
import pathlib
import struct
import zlib
from typing import Dict, Sequence

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


# The plot: a panel of 440 x 330 pixels a metric, as JAX's matplotlib
# figure of (4 x 3) inches a panel at 110 dpi. In a panel, the axes' box
# spans columns _LEFT.._RIGHT and rows _TOP.._BOTTOM; the curve keeps a
# margin of _MARGIN of the box's width and height on each side.
PANEL_W, PANEL_H = 440, 330
_LEFT, _RIGHT, _TOP, _BOTTOM = 72, 428, 34, 286
_MARGIN = 0.05
_PLOTTED = ("mse", "psnr", "ssim")
_BLACK = (0, 0, 0)
_GRID = (231, 231, 231)
CURVE = (31, 119, 180)

# 5 x 7 glyphs of the characters the plot writes: the titles, the label
# "frame", and numbers as "%.4g" prints them.
_GLYPHS = {
    "0": ("01110", "10001", "10011", "10101", "11001", "10001", "01110"),
    "1": ("00100", "01100", "00100", "00100", "00100", "00100", "01110"),
    "2": ("01110", "10001", "00001", "00010", "00100", "01000", "11111"),
    "3": ("11110", "00001", "00001", "01110", "00001", "00001", "11110"),
    "4": ("00010", "00110", "01010", "10010", "11111", "00010", "00010"),
    "5": ("11111", "10000", "11110", "00001", "00001", "10001", "01110"),
    "6": ("00110", "01000", "10000", "11110", "10001", "10001", "01110"),
    "7": ("11111", "00001", "00010", "00100", "01000", "01000", "01000"),
    "8": ("01110", "10001", "10001", "01110", "10001", "10001", "01110"),
    "9": ("01110", "10001", "10001", "01111", "00001", "00010", "01100"),
    ".": ("00000", "00000", "00000", "00000", "00000", "01100", "01100"),
    "-": ("00000", "00000", "00000", "11111", "00000", "00000", "00000"),
    "+": ("00000", "00100", "00100", "11111", "00100", "00100", "00000"),
    "e": ("00000", "00000", "01110", "10001", "11111", "10000", "01110"),
    "f": ("00110", "01001", "01000", "11100", "01000", "01000", "01000"),
    "r": ("00000", "00000", "10110", "11001", "10000", "10000", "10000"),
    "a": ("00000", "00000", "01110", "00001", "01111", "10001", "01111"),
    "m": ("00000", "00000", "11010", "10101", "10101", "10101", "10101"),
    "E": ("11111", "10000", "10000", "11110", "10000", "10000", "11111"),
    "I": ("01110", "00100", "00100", "00100", "00100", "00100", "01110"),
    "M": ("10001", "11011", "10101", "10101", "10001", "10001", "10001"),
    "N": ("10001", "11001", "10101", "10011", "10001", "10001", "10001"),
    "P": ("11110", "10001", "10001", "11110", "10000", "10000", "10000"),
    "R": ("11110", "10001", "10001", "11110", "10100", "10010", "10001"),
    "S": ("01111", "10000", "10000", "01110", "00001", "00001", "11110"),
}


def _text(image: np.ndarray, text: str, x: int, y: int, scale: int = 1,
          anchor: str = "left") -> None:
    """Draw ``text`` in black with its top at row ``y``, starting at column
    ``x`` (``anchor`` "left"), centred on it ("centre") or ending at it
    ("right"). A character outside the table raises ``KeyError``."""
    cells = [np.array([[c == "1" for c in row] for row in _GLYPHS[ch]])
             for ch in text]
    gap = np.zeros((7, 1), bool)
    bitmap = np.concatenate(
        [part for cell in cells for part in (cell, gap)][:-1], axis=1)
    bitmap = bitmap.repeat(scale, axis=0).repeat(scale, axis=1)
    h, w = bitmap.shape
    x0 = {"left": x, "centre": x - w // 2, "right": x - w}[anchor]
    image[y:y + h, x0:x0 + w][bitmap] = _BLACK


def _line(image: np.ndarray, c0: float, r0: float, c1: float,
          r1: float) -> None:
    """A line two pixels thick from (c0, r0) to (c1, r1) in CURVE."""
    n = int(max(abs(c1 - c0), abs(r1 - r0))) + 1
    cols = np.rint(np.linspace(c0, c1, n + 1)).astype(int)
    rows = np.rint(np.linspace(r0, r1, n + 1)).astype(int)
    for dr, dc in ((0, 0), (1, 0), (0, 1), (1, 1)):
        image[rows + dr, cols + dc] = CURVE


def curve_columns(n: int) -> np.ndarray:
    """The column of each of ``n`` points in a panel."""
    span = _RIGHT - _LEFT
    if n == 1:
        return np.array([_LEFT + span / 2])
    lo = _LEFT + _MARGIN * span
    return lo + (1 - 2 * _MARGIN) * span * np.arange(n) / (n - 1)


def _panel(name: str, vals: Sequence[float], n_in: int) -> np.ndarray:
    image = np.full((PANEL_H, PANEL_W, 3), 255, np.uint8)
    for k in range(1, 5):
        image[_TOP + k * (_BOTTOM - _TOP) // 5, _LEFT:_RIGHT] = _GRID
        image[_TOP:_BOTTOM, _LEFT + k * (_RIGHT - _LEFT) // 5] = _GRID
    image[[_TOP, _BOTTOM], _LEFT:_RIGHT + 1] = _BLACK
    image[_TOP:_BOTTOM + 1, [_LEFT, _RIGHT]] = _BLACK
    _text(image, name.upper(), (_LEFT + _RIGHT) // 2, 10, 2, "centre")

    vals = np.asarray(vals, np.float64)
    finite = np.isfinite(vals)
    lo, hi = ((vals[finite].min(), vals[finite].max()) if finite.any()
              else (0.0, 0.0))
    # A constant (or empty) series sits in the middle of the box.
    half = (hi - lo) / 2 or max(abs(lo), 1.0) * 0.05
    mid = (hi + lo) / 2
    lo_y, hi_y = mid - half / (1 - 2 * _MARGIN), mid + half / (1 - 2 * _MARGIN)
    cols = curve_columns(len(vals))
    rows = _BOTTOM - (vals - lo_y) / (hi_y - lo_y) * (_BOTTOM - _TOP)
    for i in range(len(vals) - 1):
        if finite[i] and finite[i + 1]:
            _line(image, cols[i], rows[i], cols[i + 1], rows[i + 1])
    if len(vals) == 1 and finite[0]:
        _line(image, cols[0], rows[0], cols[0], rows[0])

    first, last = n_in + 1, n_in + len(vals)
    _text(image, str(first), int(cols[0]), _BOTTOM + 6, 1, "centre")
    if last != first:
        _text(image, str(last), int(cols[-1]), _BOTTOM + 6, 1, "centre")
    _text(image, "frame", (_LEFT + _RIGHT) // 2, _BOTTOM + 22, 1, "centre")
    if finite.any():
        for v in sorted({lo, hi}):
            row = int(_BOTTOM - (v - lo_y) / (hi_y - lo_y) * (_BOTTOM - _TOP))
            _text(image, f"{v:.4g}", _LEFT - 4, row - 3, 1, "right")
    return image


def plot_metrics_vs_horizon(path, per_horizon: Dict[str, Sequence[float]],
                            n_in: int = 0) -> pathlib.Path:
    """A PNG with one panel for each of MSE, PSNR and SSIM that
    ``per_horizon`` holds (in its order), each curve over frames n_in + 1
    .. n_in + T with its first and last frame and its least and largest
    value written beside the axes; and ``path`` with ``.json`` holding
    every curve (LPIPS too), written as JAX writes it. No metric to plot
    raises ``ValueError``, as JAX's empty figure does."""
    metrics = [k for k in per_horizon if k in _PLOTTED]
    if not metrics:
        raise ValueError(f"no metric of {_PLOTTED} to plot in "
                         f"{sorted(per_horizon)}")
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    write_png(path, np.concatenate(
        [_panel(k, per_horizon[k], n_in) for k in metrics], axis=1))
    path.with_suffix(".json").write_text(
        json.dumps({k: list(map(float, v))
                    for k, v in per_horizon.items()}))
    return path
