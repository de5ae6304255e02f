"""Latent-space planners: the cross-entropy method and gradient ascent.

Counterpart of ``ode_rl_tpu/wm/planners.py``: plan an action sequence by
rolling candidates through a latent dynamics model and maximising the
predicted return. The caller's ``rollout_fn(actions (P, H, A), noise)``
returns (P,) returns, drawing any noise of its own from ``noise``; the
planners draw theirs from the same ``Noise`` (core/noise.py), in the
order: each CEM iteration's proposals (P, H, A) before its rollout; the
gradient planner's initial actions (H, A) before its iterations.

The CEM's new std is the population std of the elites (``correction=0``,
as ``jnp.std``) plus 1e-6. The top-k's order among equal returns does
not matter: the elites are averaged. The gradient planner's gradient is
``torch.autograd.grad`` of -mean(returns) through ``rollout_fn``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ode_rl_torch.core.noise import Noise, as_noise


def cem_planner(rollout_fn: Callable, generator, horizon: int,
                action_dim: int, iterations: int = 10, proposals: int = 1000,
                topk: int = 100, init_std: float = 1.0,
                device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """The best (H, A) action sequence: the mean of the last iteration's
    elites."""
    noise = as_noise(generator, "cem_planner")
    mean = torch.zeros((horizon, action_dim), device=device)
    std = torch.full((horizon, action_dim), float(init_std), device=device)
    for _ in range(iterations):
        candidates = mean[None] + std[None] * noise.normal(
            (proposals, horizon, action_dim), mean)
        returns = rollout_fn(candidates, noise)
        elites = candidates[torch.topk(returns, topk).indices]
        mean = elites.mean(dim=0)
        std = elites.std(dim=0, correction=0) + 1e-6
    return mean


def grad_planner(rollout_fn: Callable, generator, horizon: int,
                 action_dim: int, iterations: int = 50, lr: float = 0.1,
                 init_std: float = 0.1,
                 device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """Gradient ascent on the mean return of one (H, A) action
    sequence."""
    noise: Noise = as_noise(generator, "grad_planner")
    like = torch.zeros((), device=device)
    actions = init_std * noise.normal((horizon, action_dim), like)
    for _ in range(iterations):
        a = actions.detach().requires_grad_(True)
        objective = -torch.mean(rollout_fn(a[None], noise))
        (g,) = torch.autograd.grad(objective, a)
        actions = actions - lr * g
    return actions.detach()
