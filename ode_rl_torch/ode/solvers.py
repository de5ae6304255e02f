"""ODE solvers: euler, midpoint, rk4, adams and adaptive dopri5.

Counterpart of ``ode_rl_tpu/ode/solvers.py``. ``odeint_aux`` integrates
``dy/dt = func(t, y)`` and reports the solution at every requested time,
with gradients by backprop through the solver's own steps. The pieces the
O(NFE) solver (ode/fast.py) shares live here too: the tableau and
controller constants, ``ODEStats``, the batch-wide RMS norm (inside a
mesh, over the global batch and the whole frame: the ranks of ``'data'``
x ``'space'``, never ``'model'``, parallel/mesh.py), the error ratio,
the Hairer-Norsett-Wanner initial step and one dopri5 attempt.

The state is one tensor. Times and step sizes are fp32 host scalars
(``numpy.float32``), as JAX carries them in fp32; stage sums keep the JAX
order of summation.

dopri5 here is the JAX 'scan' solver, attempt for attempt: up to
``max_steps`` attempts, rejected ones included; ``dt`` is capped only at
the end of the span; an accepted step fills every output time in
``(t, t + dt + 1e-12]`` from its dense output; the step size and the
error ratio carry no gradient; output times the budget never reached take
the final state. The host reads one number per attempt, the error ratio,
and a rejected attempt's graph is dropped with it. With ``remat`` each
attempt runs under ``torch.utils.checkpoint``, so the backward recomputes
its six field evaluations instead of storing them.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ode_rl_torch.ode.interp import interp_eval, interp_fit
from ode_rl_torch.parallel.mesh import current, entered, global_sum, world

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
_F32 = np.float32


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
    """The RMS over every element, of the global batch and frame under a
    mesh: every rank then takes the same step sizes and attempts."""
    total = global_sum(torch.sum(torch.square(x.float())))
    return torch.sqrt(total / (x.numel() * world()))


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


def _in_mesh(mesh):
    """``_dopri5_step`` inside ``mesh``: the backward recomputes a remat'd
    attempt on autograd's thread, which does not see the entered mesh."""
    def step(*args):
        with entered(mesh):
            return _dopri5_step(*args)
    return step


def _dopri5(func: ODEFunc, y0: torch.Tensor, ts: np.ndarray, rtol: float,
            atol: float, max_steps: int, first_step: Optional[float],
            remat: bool) -> Tuple[torch.Tensor, ODEStats]:
    n_out = len(ts)
    t0, t_end = ts[0], ts[-1]
    f0 = func(t0, y0)
    nfe = 1
    if first_step is None:
        # The step size is control flow: it carries no gradient.
        with torch.no_grad():
            h = _initial_step(func, t0, y0, f0, rtol, atol)
        dt = _F32(h.item())
        nfe += 2
    else:
        dt = _F32(first_step)
    # Never open with a step beyond the span.
    dt = np.minimum(dt, t_end - t0)

    ys: List[Optional[torch.Tensor]] = [y0] + [None] * (n_out - 1)
    t, y, f = t0, y0, f0
    nacc = nrej = 0
    for _ in range(max_steps):
        if not t < t_end - _F32(1e-12):
            break
        dt_used = np.maximum(np.minimum(dt, t_end - t), _F32(1e-12))
        if remat and torch.is_grad_enabled():
            y1, f7, err, y_mid = checkpoint(_in_mesh(current()), func, t, y,
                                            f, dt_used, use_reentrant=False)
        else:
            y1, f7, err, y_mid = _dopri5_step(func, t, y, f, dt_used)
        with torch.no_grad():
            ratio = _F32(_error_ratio(err, y, y1, rtol, atol).item())
        nfe += 6
        accept = bool(ratio <= 1.0)
        if accept:
            t_new = t + dt_used
            theta = np.clip((ts - t) / dt_used, _F32(0.0), _F32(1.0))
            slots = np.flatnonzero((ts > t) & (ts <= t_new + _F32(1e-12)))
            if len(slots):
                coeffs = interp_fit(y, y1, y_mid, f, f7, float(dt_used))
                for s in slots:
                    ys[s] = interp_eval(coeffs, float(theta[s])).to(y.dtype)
            t, y, f = t_new, y1, f7
            nacc += 1
        else:
            nrej += 1
        # I-controller with its clamps.
        if ratio <= 1e-10:
            factor = _F32(_IFACTOR)
        else:
            factor = np.clip(_F32(_SAFETY) * ratio ** _F32(-1.0 / _ORDER),
                             _F32(_DFACTOR), _F32(_IFACTOR))
        if not accept:
            factor = np.minimum(factor, _F32(1.0))
        dt = dt_used * factor

    # Output times never reached take the final state (and route their
    # gradient to it).
    for s in np.flatnonzero(ts > t + _F32(1e-12)):
        ys[s] = y
    ys = [torch.zeros_like(y0) if v is None else v for v in ys]
    stats = ODEStats(nfe=nfe, naccept=nacc, nreject=nrej,
                     converged=bool(t >= t_end - _F32(1e-10)))
    return torch.stack(ys), stats


# ----------------------------- fixed-step ---------------------------------

def _euler_step(func: ODEFunc, t, y, h):
    return y + float(h) * func(t, y)


def _midpoint_step(func: ODEFunc, t, y, h):
    y_mid = y + float(_F32(0.5) * h) * func(t, y)
    return y + float(h) * func(t + _F32(0.5) * h, y_mid)


def _rk4_step(func: ODEFunc, t, y, h):
    half = _F32(0.5) * h
    k1 = func(t, y)
    k2 = func(t + half, y + float(half) * k1)
    k3 = func(t + half, y + float(half) * k2)
    k4 = func(t + h, y + float(h) * k3)
    w = [float(h / _F32(6)), float(h / _F32(3)), float(h / _F32(3)),
         float(h / _F32(6))]
    return _axpy(w, [k1, k2, k3, k4], y, 1.0)


_FIXED = {"euler": (_euler_step, 1), "midpoint": (_midpoint_step, 2),
          "rk4": (_rk4_step, 4)}


def _fixed_grid(func: ODEFunc, y0, ts: np.ndarray, method: str,
                substeps: int) -> Tuple[torch.Tensor, ODEStats]:
    """``substeps`` equal steps per output interval."""
    stepper, evals = _FIXED[method]
    ys, y = [y0], y0
    for t_a, t_b in zip(ts[:-1], ts[1:]):
        h = (t_b - t_a) / _F32(substeps)
        for i in range(substeps):
            y = stepper(func, t_a + _F32(i) * h, y, h).to(y.dtype)
        ys.append(y)
    n = (len(ts) - 1) * substeps
    return torch.stack(ys), ODEStats(nfe=n * evals, naccept=n, nreject=0,
                                     converged=True)


def _adams(func: ODEFunc, y0, ts: np.ndarray
           ) -> Tuple[torch.Tensor, ODEStats]:
    """Explicit 4-step Adams-Bashforth on the output grid, bootstrapped
    with RK4 over the first three intervals."""
    h_all = ts[1:] - ts[:-1]
    ys, y, fs = [y0], y0, []
    n_boot = min(3, len(ts) - 1)
    for i in range(n_boot):
        fs.append(func(ts[i], y))
        y = _rk4_step(func, ts[i], y, h_all[i])
        ys.append(y)
    hist = ([fs[0]] * (4 - len(fs)) + fs)[-4:]   # oldest first
    for i in range(n_boot, len(ts) - 1):
        hist = hist[1:] + [func(ts[i], y)]
        s0, s1, s2, s3 = hist
        y = y + float(h_all[i]) * (55 * s3 - 59 * s2 + 37 * s1 - 9 * s0) / 24
        ys.append(y)
    n = len(ts) - 1
    return torch.stack(ys), ODEStats(nfe=2 * n, naccept=n, nreject=0,
                                     converged=True)


def odeint_aux(func: ODEFunc, y0: torch.Tensor, ts, *,
               method: str = "dopri5", rtol: float = 1e-4,
               atol: float = 1e-5, max_steps: int = 256, substeps: int = 1,
               first_step: Optional[float] = None, remat: bool = True
               ) -> Tuple[torch.Tensor, ODEStats]:
    """Integrate ``dy/dt = func(t, y)`` from ``ts[0]``; returns (ys
    (len(ts), *y0.shape), stats) with ``ys[0] == y0``. ``ts`` (a tensor or
    an array) must be increasing; gradients flow through the solver's
    steps."""
    if isinstance(ts, torch.Tensor):
        ts = ts.detach().cpu().numpy()
    ts = np.asarray(ts, np.float32)
    if ts.ndim != 1:
        raise ValueError("ts must be 1-D")
    if ts.shape[0] == 1:
        return y0[None], ODEStats(0, 0, 0, True)
    if method == "dopri5":
        return _dopri5(func, y0, ts, float(rtol), float(atol),
                       int(max_steps), first_step, remat)
    if method in _FIXED:
        return _fixed_grid(func, y0, ts, method, int(substeps))
    if method == "adams":
        return _adams(func, y0, ts)
    raise ValueError(f"unknown method {method!r} "
                     "(supported: dopri5, euler, midpoint, rk4, adams)")
