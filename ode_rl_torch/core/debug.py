"""The NaN guard of the train step, ``debug_nans`` and ``checked_odeint``.

Counterpart of ``all_finite``, ``nan_guard_update`` and
``checked_odeint`` in ``ode_rl_tpu/core/debug.py``, and of the ``jax_debug_nans`` flag that
``debug_nans`` turns on in JAX (``ode_rl_tpu/train/loop.py::setup``),
which raises ``FloatingPointError`` at the first operation that makes a
NaN. Here ``nan_checks`` raises it for the step: at the first backward
node that returns a NaN (``torch.autograd.detect_anomaly``, which names
that node and prints where its forward ran), and ``check_finite`` at a
forward whose loss, metrics or prediction hold a NaN. Neither changes
a finite step's numbers; both sync with the host.

The guard: where a gradient holds a non-finite value,
the step's parameter update is undone. As in JAX, only the parameters are
guarded: the optimizer's state has already taken the non-finite step, so
Adam's moments hold NaN and the next finite step writes NaN into the
parameters (ROADMAP queue 3 records this fault of the JAX package, which
the port keeps so that both give the same results). Both run on the
device, with no host sync.

``checked_odeint`` is ``odeint_aux`` with every field output and the
solution checked for finiteness; it raises ``FloatingPointError`` naming
the time of the first non-finite field output. It reads a flag on the
host at every evaluation (JAX's checkify version raises from the
device), which a debugging tool may: no training path calls it.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Iterator, Mapping, Sequence

import torch

from ode_rl_torch.ode.solvers import odeint_aux


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """A 0-d bool tensor: every element of every tensor is finite."""
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


@torch.no_grad()
def nan_guard_update(params: Sequence[torch.Tensor],
                     old_params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor],
                     mesh=None) -> torch.Tensor:
    """Put ``old_params`` back into ``params`` (in place) unless every
    gradient is finite, on every rank of ``mesh`` (where one is given:
    a rank's ``'model'`` slices are its own); returns the int32
    'skipped' flag, 0 or 1."""
    ok = all_finite(grads)
    if mesh is not None and mesh.world > 1:
        bad = (~ok).to(torch.float32).reshape(1)
        ok = mesh.all_reduce_(bad)[0] == 0
    for p, old in zip(params, old_params):
        p.copy_(torch.where(ok, p, old))
    return (~ok).to(torch.int32)


def check_finite(where: str, tensors: Mapping[str, torch.Tensor]) -> None:
    """Raise ``FloatingPointError`` naming the first of ``tensors`` that
    holds a NaN."""
    for name, t in tensors.items():
        if torch.is_tensor(t) and t.is_floating_point() and bool(
                torch.isnan(t).any()):
            raise FloatingPointError(f"debug_nans: NaN in {name} of the "
                                     f"{where}")


@contextlib.contextmanager
def nan_checks(enabled: bool) -> Iterator[None]:
    """Autograd's anomaly mode, its NaN in a backward as
    ``FloatingPointError``; nothing where not ``enabled``."""
    if not enabled:
        yield
        return
    with torch.autograd.detect_anomaly(check_nan=True):
        try:
            yield
        except RuntimeError as e:
            if "nan values" not in str(e):
                raise
            raise FloatingPointError(f"debug_nans: {e}") from e


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all())


def checked_odeint(func, y0: torch.Tensor, ts, **kwargs):
    """``odeint_aux(func, y0, ts, **kwargs)`` -> (ys, stats), raising
    ``FloatingPointError`` where a field output or the solution holds a
    non-finite value; on a finite run its results are ``odeint_aux``'s."""

    def checked_func(t, y):
        dy = func(t, y)
        if not _finite(dy):
            raise FloatingPointError(
                f"non-finite dynamics output at t={float(t)}")
        return dy

    ys, stats = odeint_aux(checked_func, y0, ts, **kwargs)
    if not _finite(ys):
        raise FloatingPointError("non-finite ODE solution")
    return ys, stats
