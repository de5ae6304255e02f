"""O(NFE) adaptive dopri5: early-exiting forward, replaying adjoint.

Counterpart of ``ode_rl_tpu/ode/fast.py``. The forward runs without
autograd and records the accepted steps (t, dt, y, output cursor); the
backward replays only those steps, in reverse, pulling cotangents through
``torch.autograd.grad`` of one dopri5 step plus its dense-output fill.
Both directions cost O(NFE); ``max_steps`` only bounds the loop.

Semantics follow the JAX solver step for step:

* NFE starts at 3 (the first field evaluation and the two of the HNW
  initial step), which is clamped to the span;
* windowed dense output: a step fills at most ``_fill_width`` output
  slots from the cursor on, and is capped at the window's last slot;
* acceptance on the batch-wide RMS error ratio, and the dt controller
  with its cap-aware ``dt_next``;
* output slots the step budget never reached take the final state, and
  the backward seeds their cotangent sum into the final state's;
* ``ys[0]`` is y0 and passes its cotangent straight through;
* gradients through the step-size controller are dropped.

Times and step sizes are fp32 host scalars, as JAX carries them, so the
fill test ``ts <= t + dt + 1e-12`` and the caps match the reference. The
host reads one number per attempt, the error ratio.

The dynamics take parameters explicitly, ``func(t, y, params)`` with
``params`` a dict of tensors; they are inputs of the autograd Function,
whose backward returns their gradients.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ode_rl_torch.ode.interp import interp_eval, interp_fit
from ode_rl_torch.ode.solvers import (
    _DFACTOR, _IFACTOR, _ORDER, _SAFETY, ODEStats, _dopri5_step,
    _error_ratio, _initial_step)

# Base width of the dense-output fill window (see _fill_width).
_FILL_W = 4
_F32 = np.float32

Params = Dict[str, torch.Tensor]
Func = Callable[[np.float32, torch.Tensor, Params], torch.Tensor]


def _fill_width(n_out: int, max_steps: int) -> int:
    """Window width: every accepted step is capped at the window edge, so
    a solve needs at least ceil(n_out / W) accepted steps; widen W so that
    floor is at most half the budget."""
    need = -(-2 * n_out // max(max_steps, 2))   # ceil(2·n_out/max_steps)
    return max(_FILL_W, need)


def _window(ts_pad: np.ndarray, k_out: int, fill_w: int, t: np.float32,
            dt: np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Output slots the step (t, t + dt] fills, and their fractions."""
    ts_w = ts_pad[k_out:k_out + fill_w]
    fill = (ts_w > t) & (ts_w <= t + dt + _F32(1e-12))
    theta = np.clip((ts_w - t) / dt, _F32(0.0), _F32(1.0))
    slots = np.flatnonzero(fill)
    return k_out + slots, theta[slots]


def _step_and_fill(func: Func, params: Params, t, dt, y, thetas):
    """One accepted dopri5 step and its dense-output values (the unit the
    backward replays)."""
    g = lambda tt, yy: func(tt, yy, params)
    f0 = g(t, y)  # FSAL: equal to the carried stage 7 of the prior step
    y1, f7, _err, y_mid = _dopri5_step(g, t, y, f0, dt)
    coeffs = interp_fit(y, y1, y_mid, f0, f7, float(dt))
    return y1, [interp_eval(coeffs, float(th)).to(y.dtype) for th in thetas]


class _Problem:
    """The non-tensor part of one solve, and its results for the caller."""

    def __init__(self, func: Func, names: List[str], ts: np.ndarray,
                 rtol: float, atol: float, max_steps: int):
        self.func, self.names, self.ts = func, names, ts
        self.rtol, self.atol, self.max_steps = rtol, atol, max_steps
        self.stats: ODEStats | None = None
        self.history: list = []    # (t, dt, y, output slots, thetas)
        self.k_out = 1

    def forward(self, y0: torch.Tensor, params: Params) -> torch.Tensor:
        g = lambda tt, yy: self.func(tt, yy, params)
        ts = self.ts
        n_out = len(ts)
        t0, t_end = ts[0], ts[-1]
        f0 = g(t0, y0)
        h = _initial_step(g, t0, y0, f0, self.rtol, self.atol)
        dt = np.minimum(_F32(h.item()), t_end - t0)

        fill_w = _fill_width(n_out, self.max_steps)
        # Sentinel times past the end: window slices never run short, and
        # a sentinel never passes the fill test.
        big = np.abs(t_end) + np.abs(t_end - t0) + _F32(1e3)
        ts_pad = np.concatenate([ts, np.full(fill_w, big, np.float32)])
        ys: list = [y0] + [None] * (n_out - 1)
        t, y, f, k_out = t0, y0, f0, 1
        k = nrej = 0
        while t < t_end - _F32(1e-12) and k < self.max_steps:
            # Cap the step at the window's last output (saturating at
            # ts[-1], so never past t_end).
            t_cap = ts_pad[min(k_out + fill_w - 1, n_out - 1)]
            dt_used = np.maximum(np.minimum(dt, t_cap - t), _F32(1e-12))
            y1, f7, err, y_mid = _dopri5_step(g, t, y, f, dt_used)
            ratio = _F32(_error_ratio(err, y, y1, self.rtol,
                                      self.atol).item())
            accept = bool(ratio <= 1.0)
            if accept:
                slots, thetas = _window(ts_pad, k_out, fill_w, t, dt_used)
                if len(slots):
                    coeffs = interp_fit(y, y1, y_mid, f, f7, float(dt_used))
                    for slot, th in zip(slots, thetas):
                        ys[slot] = interp_eval(coeffs, float(th)).to(y.dtype)
                self.history.append((t, dt_used, y, slots, thetas))
                t, y, f, k_out = t + dt_used, y1, f7, k_out + len(slots)
            else:
                nrej += 1

            if ratio <= 1e-10:
                factor = _F32(_IFACTOR)
            else:
                factor = np.clip(_F32(_SAFETY) * ratio ** _F32(-1.0 / _ORDER),
                                 _F32(_DFACTOR), _F32(_IFACTOR))
            if not accept:
                factor = np.minimum(factor, _F32(1.0))
            # A capped, accepted step shrank dt artificially: keep at least
            # the prior proposal so the cap does not ratchet dt down.
            if accept and dt_used < dt:
                dt = np.maximum(dt, dt_used * factor)
            else:
                dt = dt_used * factor
            k += 1

        # Budget exhausted: unreached slots take the final state.
        for slot in range(k_out, n_out):
            ys[slot] = y
        self.k_out = k_out
        self.stats = ODEStats(nfe=3 + 6 * k, naccept=len(self.history),
                              nreject=nrej,
                              converged=bool(t >= t_end - _F32(1e-10)))
        return torch.stack(ys)

    def backward(self, ct_ys: torch.Tensor, y0: torch.Tensor,
                 param_values: Tuple[torch.Tensor, ...]):
        ct_ys = ct_ys.float()
        # Unreached slots hold the final state: their cotangents flow into
        # it.
        ct_y = ct_ys[self.k_out:].sum(dim=0)
        ct_p = [torch.zeros_like(p, dtype=torch.float32)
                for p in param_values]
        for t, dt, y, slots, thetas in reversed(self.history):
            with torch.enable_grad():
                y_i = y.detach().requires_grad_(True)
                leaves = [p.detach().requires_grad_(True)
                          for p in param_values]
                y1, fills = _step_and_fill(
                    self.func, dict(zip(self.names, leaves)), t, dt, y_i,
                    thetas)
                grads = torch.autograd.grad(
                    [y1, *fills], [y_i, *leaves],
                    [ct_y.to(y1.dtype), *[ct_ys[s].to(y1.dtype)
                                          for s in slots]],
                    allow_unused=True)
            ct_y = grads[0].float()
            ct_p = [acc if gp is None else acc + gp.float()
                    for acc, gp in zip(ct_p, grads[1:])]
        ct_y0 = (ct_y + ct_ys[0]).to(y0.dtype)
        return ct_y0, [c.to(p.dtype) for c, p in zip(ct_p, param_values)]


class _OdeintFast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, problem: _Problem, y0: torch.Tensor, *param_values):
        ctx.problem = problem
        ctx.save_for_backward(y0, *param_values)
        return problem.forward(y0, dict(zip(problem.names, param_values)))

    @staticmethod
    def backward(ctx, ct_ys):
        y0, *param_values = ctx.saved_tensors
        ct_y0, ct_params = ctx.problem.backward(ct_ys, y0,
                                                tuple(param_values))
        return (None, ct_y0, *ct_params)


def odeint_fast(func: Func, y0: torch.Tensor, ts, params: Params, *,
                rtol: float = 1e-4, atol: float = 1e-5,
                max_steps: int = 256) -> Tuple[torch.Tensor, ODEStats]:
    """Adaptive dopri5 with O(NFE) forward and backward.

    ``func(t, y, params) -> dy/dt``; ``ts`` (n_out,) output times, a
    tensor or array, increasing. Returns (ys (n_out, *y0.shape), stats)."""
    if isinstance(ts, torch.Tensor):
        ts = ts.detach().cpu().numpy()
    ts = np.asarray(ts, np.float32)
    if ts.shape[0] == 1:
        return y0[None], ODEStats(0, 0, 0, True)
    problem = _Problem(func, list(params), ts, float(rtol), float(atol),
                       int(max_steps))
    ys = _OdeintFast.apply(problem, y0, *params.values())
    return ys, problem.stats
