"""Dormand-Prince 5(4) pieces shared by the adaptive solvers.

Counterpart of the parts of ``ode_rl_tpu/ode/solvers.py`` that the O(NFE)
solver (ode/fast.py) uses: the tableau and controller constants,
``ODEStats``, the batch-wide RMS norm, the error ratio, the
Hairer-Norsett-Wanner initial step and one dopri5 attempt. The state is
one tensor. Times and step sizes are fp32 host scalars (``numpy.float32``),
as JAX carries them in fp32; stage sums keep the JAX order of summation.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

# Dormand-Prince 5(4) Butcher tableau.
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0], np.float32)
_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_B = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
_B_ERR = [  # b5 - b4: weights of the embedded error estimate
    35 / 384 - 5179 / 57600,
    0.0,
    500 / 1113 - 7571 / 16695,
    125 / 192 - 393 / 640,
    -2187 / 6784 + 92097 / 339200,
    11 / 84 - 187 / 2100,
    -1 / 40,
]
# Midpoint weights for the quartic dense-output fit (Shampine).
_C_MID = [
    0.5 * 6025192743 / 30085553152,
    0.0,
    0.5 * 51252292925 / 65400821598,
    0.5 * -2691868925 / 45128329728,
    0.5 * 187940372067 / 1594534317056,
    0.5 * -1776094331 / 19743644256,
    0.5 * 11237099 / 235043384,
]

_SAFETY = 0.9
_IFACTOR = 10.0
_DFACTOR = 0.2
_ORDER = 5.0

ODEFunc = Callable[[np.float32, torch.Tensor], torch.Tensor]


class ODEStats(NamedTuple):
    nfe: int          # number of dynamics-function evaluations
    naccept: int      # accepted steps
    nreject: int      # rejected steps
    converged: bool   # True iff t reached ts[-1] within max_steps


def _axpy(alpha, xs, y: Optional[torch.Tensor], scale: float):
    """y + scale * sum(w_i * x_i), summed left to right; zero weights are
    skipped. ``y=None`` stands for a zero tensor."""
    acc = None
    for w, x in zip(alpha, xs):
        if w == 0.0:
            continue
        acc = w * x if acc is None else acc + w * x
    if y is None:
        return scale * acc
    return y + scale * acc


def _rms_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(x.float())) / x.numel())


def _error_ratio(err, y0, y1, rtol: float, atol: float) -> torch.Tensor:
    scale = atol + rtol * torch.maximum(y0.abs(), y1.abs())
    return _rms_norm((err / scale).float())


def _initial_step(func: ODEFunc, t0, y0, f0, rtol: float,
                  atol: float) -> torch.Tensor:
    """Hairer-Norsett-Wanner automatic initial step size (2 extra evals);
    a 0-d fp32 tensor on the state's device."""
    scale = atol + rtol * y0.abs()
    d0 = _rms_norm(y0 / scale)
    d1 = _rms_norm(f0 / scale)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, 1e-6, 0.01 * d0 / torch.clamp(d1, min=1e-30))
    y1 = y0 + h0 * f0
    f1 = func(float(t0) + h0, y1)
    d2 = _rms_norm((f1 - f0) / scale) / h0
    d_max = torch.maximum(d1, d2)
    h1 = torch.where(d_max <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / d_max) ** (1.0 / _ORDER))
    return torch.minimum(100.0 * h0, h1)


def _dopri5_step(func: ODEFunc, t: np.float32, y: torch.Tensor,
                 f0: torch.Tensor, dt: np.float32):
    """One Dormand-Prince attempt. Returns (y1, f7, err, y_mid)."""
    ks = [f0]
    h = float(dt)
    for i in range(1, 7):
        ti = t + _C[i] * dt
        ks.append(func(ti, _axpy(_A[i], ks, y, h)))
    y1 = _axpy(_B, ks, y, h)          # == the stage-7 state (FSAL)
    err = _axpy(_B_ERR, ks, None, h)
    y_mid = _axpy(_C_MID, ks, y, h)
    # Keep the state's dtype; the error stays fp32 for the norm.
    return y1.to(y.dtype), ks[6].to(y.dtype), err, y_mid.to(y.dtype)
