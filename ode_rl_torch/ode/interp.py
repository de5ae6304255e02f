"""Quartic dense-output interpolation for adaptive RK solvers.

Counterpart of ``ode_rl_tpu/ode/interp.py``: the Shampine interpolant
through (y0, y_mid, y1) with endpoint slopes (f0, f1) over one step,
evaluated at fractions theta in [0, 1] of the step.
"""

from __future__ import annotations

import torch


def interp_fit(y0, y1, y_mid, f0, f1, dt):
    """Coefficients (a, b, c, d, e) with
    y(t0 + theta*dt) = e + theta*(d + theta*(c + theta*(b + theta*a)))."""
    a = 2.0 * dt * (f1 - f0) - 8.0 * (y1 + y0) + 16.0 * y_mid
    b = dt * (5.0 * f0 - 3.0 * f1) + 18.0 * y0 + 14.0 * y1 - 32.0 * y_mid
    c = dt * (f1 - 4.0 * f0) - 11.0 * y0 - 5.0 * y1 + 16.0 * y_mid
    d = dt * f0
    e = y0
    return a, b, c, d, e


def interp_eval(coeffs, theta) -> torch.Tensor:
    """Evaluate the fitted polynomial at fraction ``theta`` of the step."""
    a, b, c, d, e = coeffs
    return e + theta * (d + theta * (c + theta * (b + theta * a)))
