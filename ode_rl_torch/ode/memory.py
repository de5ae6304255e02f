"""Memory-mode ODE decoding: ``nru`` (stepwise) and ``nru2`` (two-pass).

Counterpart of ``ode_rl_tpu/ode/memory.py``, the stable forms of the
reference's two long-horizon modes:

* ``nru``: stepwise integration, h_{i+1} = solve(h_i, [t_i, t_{i+1}]) over
  the grid ``[t_start, *tp]``, each interval an adaptive solve of its own
  with the full ``max_steps`` budget;
* ``nru2``: one global solve over the whole grid first, summarized as its
  mean displacement from z0, bounded to half of ``|z0|`` for each sample
  (with 1e-8 in the divisor), added to z0 without a gradient; then the
  ``nru`` pass from that state. JAX takes the displacement under a
  stop-gradient, so the first pass runs here under ``torch.no_grad()``:
  the gradient is the same, and no graph is kept for it.

The metrics hold only the summed NFE, the first pass's included.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ode_rl_torch.ode.solvers import odeint_aux


def _bounded_displacement(traj: torch.Tensor, z: torch.Tensor
                          ) -> torch.Tensor:
    """mean(traj) - z, scaled down to at most 0.5 |z| for each sample."""
    d = traj.mean(dim=0) - z
    dims = tuple(range(1, d.ndim))
    dn = torch.sqrt(torch.sum(d * d, dim=dims, keepdim=True))
    zn = torch.sqrt(torch.sum(z * z, dim=dims, keepdim=True))
    return d * torch.clamp(0.5 * zn / (dn + 1e-8), max=1.0)


def odeint_memory(f: Callable, z0: torch.Tensor, t_start, tp, *,
                  method: str = "dopri5", rtol: float = 1e-3,
                  atol: float = 1e-4, max_steps: int = 128,
                  mode: str = "nru") -> Tuple[torch.Tensor, Dict]:
    """Memory-mode decode of the trajectory at ``tp`` from ``z0`` at
    ``t_start``. Returns (ys time-first (len(tp), ...), {"nfe": n})."""
    if mode not in ("nru", "nru2"):
        raise NotImplementedError(f"memory mode {mode!r} (nru|nru2)")
    as_np = lambda t: np.asarray(
        t.detach().cpu() if isinstance(t, torch.Tensor) else t, np.float32)
    t_grid = np.concatenate([as_np(t_start).reshape(1), as_np(tp)])
    solve = lambda y, ts: odeint_aux(f, y, ts, method=method, rtol=rtol,
                                     atol=atol, max_steps=max_steps)

    h, nfe = z0, 0
    if mode == "nru2":
        with torch.no_grad():
            ys1, stats1 = solve(z0, t_grid)
            disp = _bounded_displacement(ys1, z0)
        h, nfe = z0 + disp, stats1.nfe

    ys = []
    for pair in zip(t_grid[:-1], t_grid[1:]):
        seg, stats = solve(h, np.array(pair, np.float32))
        h = seg[-1]
        ys.append(h)
        nfe += stats.nfe
    return torch.stack(ys), {"nfe": nfe}
