"""The NaN guard of the train step.

Counterpart of ``all_finite`` and ``nan_guard_update`` in
``ode_rl_tpu/core/debug.py``: where a gradient holds a non-finite value,
the step's parameter update is undone. As in JAX, only the parameters are
guarded: the optimizer's state has already taken the non-finite step, so
Adam's moments hold NaN and the next finite step writes NaN into the
parameters (ROADMAP queue 3 records this fault of the JAX package, which
the port keeps so that both give the same results). Both run on the
device, with no host sync.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """A 0-d bool tensor: every element of every tensor is finite."""
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


@torch.no_grad()
def nan_guard_update(params: Sequence[torch.Tensor],
                     old_params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """Put ``old_params`` back into ``params`` (in place) unless every
    gradient is finite; returns the int32 'skipped' flag, 0 or 1."""
    ok = all_finite(grads)
    for p, old in zip(params, old_params):
        p.copy_(torch.where(ok, p, old))
    return (~ok).to(torch.int32)
