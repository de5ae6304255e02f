"""``train/metrics.py`` of the port against the JAX package's on the same
arrays: ``mse``, ``psnr``, ``ssim`` (constant and identical frames
included) and ``per_frame_metrics``, to 1e-5 relative (PSNR, a log, and
SSIM, a mean of ratios near 1, are held to 1e-5 absolute as well)."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_util import np32, t32
from ode_rl_torch.train import metrics as port
from ode_rl_tpu.train import metrics as ref


def _close(a, b, tol=1e-5):
    a, b = np32(a), np32(b)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def _videos(seed, shape=(2, 5, 24, 24, 1)):
    rng = np.random.RandomState(seed)
    pred = rng.uniform(0, 1, shape).astype(np.float32)
    target = np.clip(pred + rng.normal(0, 0.1, shape), 0, 1).astype(
        np.float32)
    return pred, target


@pytest.mark.parametrize("case", ["noisy", "identical", "constant",
                                  "one_constant", "three_channels"])
def test_ssim_matches_jax(case):
    pred, target = _videos(0, (3, 20, 20, 3 if case == "three_channels"
                               else 1))
    if case == "identical":
        target = pred
    elif case == "constant":
        pred = np.full_like(pred, 0.3)
        target = np.full_like(pred, 0.7)
    elif case == "one_constant":
        target = np.zeros_like(pred)
    x, y = pred * 255.0, target * 255.0
    ours = port.ssim(t32(x), t32(y))
    _close(ours, ref.ssim(jnp.asarray(x), jnp.asarray(y)))
    if case == "identical":
        assert abs(float(ours) - 1.0) <= 1e-5


def test_mse_and_psnr_match_jax():
    pred, target = _videos(1)
    _close(port.mse(t32(pred), t32(target)),
           ref.mse(jnp.asarray(pred), jnp.asarray(target)))
    _close(port.psnr(t32(pred), t32(target)),
           ref.psnr(jnp.asarray(pred), jnp.asarray(target)))
    # Equal frames: the MSE floor keeps PSNR finite (120 dB).
    _close(port.psnr(t32(pred), t32(pred)),
           ref.psnr(jnp.asarray(pred), jnp.asarray(pred)))


def test_per_frame_metrics_match_jax():
    pred, target = _videos(2)
    target[:, 0] = pred[:, 0]           # a perfect first horizon
    ours = port.per_frame_metrics(t32(pred), t32(target))
    theirs = ref.per_frame_metrics(jnp.asarray(pred), jnp.asarray(target))
    assert set(ours) == set(theirs) == {"mse", "psnr", "ssim"}
    for k in ours:
        assert tuple(ours[k].shape) == (pred.shape[1],)
        _close(ours[k], theirs[k])
