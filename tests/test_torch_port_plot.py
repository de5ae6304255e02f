"""The port's metric-vs-horizon plot (train/visualize.py) against JAX's.

``plot_metrics_vs_horizon`` writes, for the same curves, a JSON byte-equal
to JAX's (every key, LPIPS too) and a PNG of JAX's pixel size: a 440 x
330 panel for each of MSE, PSNR and SSIM present, in the dict's order.
The PNG is decoded here with zlib: the curve's highest pixel lies in the
column of the series' maximum, a constant series draws one flat line,
and with no metric to plot both packages raise ``ValueError``.
"""

import pathlib
import struct
import zlib

import numpy as np
import pytest

from ode_rl_torch.train.visualize import (CURVE, PANEL_H, PANEL_W,
                                          curve_columns,
                                          plot_metrics_vs_horizon)


def _decode(path: pathlib.Path) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB PNG whose rows all take filter 0."""
    data, pos, idat = path.read_bytes(), 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
            assert body[8:10] == b"\x08\x02"
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def _size(path: pathlib.Path) -> tuple:
    return struct.unpack(">II", path.read_bytes()[16:24])


def _curve(panel: np.ndarray) -> tuple:
    """Rows and columns of the curve's pixels in one panel."""
    return np.nonzero((panel == CURVE).all(axis=-1))


@pytest.mark.parametrize("keys", [("mse", "psnr", "ssim",
                                   "lpips_uncalibrated"), ("ssim",),
                                  ("psnr", "mse")])
def test_json_byte_equal_and_png_size_of_jax(keys, tmp_path):
    from ode_rl_tpu.train.visualize import plot_metrics_vs_horizon as jplot

    rng = np.random.RandomState(0)
    per_horizon = {k: (rng.rand(9) * 30).astype(np.float32).tolist()
                   for k in keys}
    ours = plot_metrics_vs_horizon(tmp_path / "ours" / "m.png", per_horizon,
                                   n_in=10)
    theirs = jplot(tmp_path / "jax" / "m.png", per_horizon, n_in=10)
    assert (ours.with_suffix(".json").read_bytes()
            == theirs.with_suffix(".json").read_bytes())
    n = len([k for k in keys if k in ("mse", "psnr", "ssim")])
    assert _size(ours) == _size(theirs) == (PANEL_W * n, PANEL_H)
    assert _decode(ours).shape == (PANEL_H, PANEL_W * n, 3)


@pytest.mark.parametrize("n,peak", [(90, 37), (7, 0), (20, 19)])
def test_highest_curve_pixel_in_the_column_of_the_maximum(n, peak,
                                                          tmp_path):
    vals = np.sin(np.linspace(0, 3, n)) * 0.1
    vals[peak] = 1.0
    flat = np.full(n, 25.0)
    path = plot_metrics_vs_horizon(tmp_path / "m.png",
                                   {"psnr": flat, "mse": vals}, n_in=10)
    image = _decode(path)
    rows, cols = _curve(image[:, PANEL_W:])
    top = cols[rows == rows.min()]
    want = int(np.rint(curve_columns(n)[peak]))
    assert want in top and top.max() - top.min() <= 2, (want, top)


@pytest.mark.parametrize("value", [0.0, 0.9, 31.5])
def test_constant_series_draws_one_flat_line(value, tmp_path):
    path = plot_metrics_vs_horizon(tmp_path / "m.png",
                                   {"ssim": [value] * 12})
    rows, cols = _curve(_decode(path))
    assert rows.max() - rows.min() == 1
    assert cols.min() == int(np.rint(curve_columns(12)[0]))
    assert cols.max() == int(np.rint(curve_columns(12)[-1])) + 1


def test_no_plotted_metric_raises_as_jax(tmp_path):
    from ode_rl_tpu.train.visualize import plot_metrics_vs_horizon as jplot

    for plot in (plot_metrics_vs_horizon, jplot):
        with pytest.raises(ValueError):
            plot(tmp_path / "m.png", {"lpips_uncalibrated": [0.1, 0.2]})
    assert not (tmp_path / "m.json").exists()
