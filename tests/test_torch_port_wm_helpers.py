"""The world-model helpers of the port against the JAX package: episode
chunking, the episode loader and the two planners.

* ``break_batch`` on the same video: equal to JAX's, element for element.
* ``EpisodeLoader``: the batch shapes JAX's gives at (batch, episode,
  chunk) = (4, 200, 50), (6, 200, 50), (8, 20, 10) and (3, 25, 10), the
  short batch of JAX's fault pinned (6 at 200/50 gives 4 rows), frames in
  [-0.5, 0.5], consecutive chunks of one episode continuous; the port's
  draws are its generator's, not JAX's keys'.
* ``cem_planner`` and ``grad_planner`` on a differentiable toy rollout
  (a quadratic around a target with a sine term), JAX's normal draws
  replayed in order: the plans to 1e-5 max abs (the elites' mean and
  std, and 30 gradient steps, summed in another order). With 4 elites
  the CEM's population std matters: the same loop with torch's default
  ``correction=1`` lies far beyond that tolerance from JAX's plan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import DrawReplay, max_abs, t32
from ode_rl_torch.wm.datasets import EpisodeLoader, break_batch
from ode_rl_torch.wm.planners import cem_planner, grad_planner

H, A = 4, 2
TARGET = np.array([[0.7, -0.3], [0.1, 0.5], [-0.6, 0.2], [0.3, 0.3]],
                  np.float32)


def test_break_batch_matches_jax():
    from ode_rl_tpu.wm.datasets import break_batch as jbreak

    video = np.random.RandomState(0).randn(3, 23, 4, 5, 1).astype(np.float32)
    for length in (5, 7, 23):
        ours = break_batch(t32(video), length)
        ref = jbreak(jnp.asarray(video), length)
        assert ours.shape == ref.shape
        assert np.array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("batch,episode,chunk,rows", [
    (4, 200, 50, 4), (6, 200, 50, 4), (8, 20, 10, 8), (3, 25, 10, 2)])
def test_episode_loader_shapes_match_jax(batch, episode, chunk, rows):
    from ode_rl_tpu.wm.datasets import EpisodeLoader as JLoader

    ref = next(JLoader(batch, episode, chunk, seed=0))["image"]
    loader = EpisodeLoader(batch, episode, chunk, seed=0)
    ours = next(loader)["image"]
    assert tuple(ours.shape) == ref.shape == (rows, chunk, 64, 64, 1)
    assert float(ours.min()) >= -0.5 and float(ours.max()) <= 0.5
    assert not torch.equal(next(loader)["image"], ours)


def test_episode_loader_chunks_one_episode_in_order():
    """With 4 chunks an episode and 8 rows, rows 0-3 are episode 0."""
    loader = EpisodeLoader(8, 40, 10, seed=3)
    gen = torch.Generator().manual_seed(3)
    from ode_rl_torch.data.mmnist import generate_moving_mnist
    episodes = generate_moving_mnist(gen, loader.bank, 2, 40, 2)
    rows = next(loader)["image"]
    assert torch.equal(rows[:4].reshape(40, 64, 64, 1), episodes[0])
    assert torch.equal(rows[4:].reshape(40, 64, 64, 1), episodes[1])


def _rollout_np(cand):
    return -np.sum((cand - TARGET) ** 2, axis=(1, 2)) + np.sum(
        np.sin(3 * cand), axis=(1, 2))


def _jax_rollout(cand, key):
    return (-jnp.sum((cand - TARGET[None]) ** 2, axis=(1, 2))
            + jnp.sum(jnp.sin(3 * cand), axis=(1, 2)))


def _port_rollout(cand, noise):
    t = torch.from_numpy(TARGET)
    return (-torch.sum((cand - t[None]) ** 2, dim=(1, 2))
            + torch.sum(torch.sin(3 * cand), dim=(1, 2)))


def _cem_draws(key, iterations, proposals):
    out = []
    for it in jax.random.split(key, iterations):
        k1, _ = jax.random.split(it)
        out.append(("normal", np.asarray(jax.random.normal(
            k1, (proposals, H, A)), np.float32)))
    return out


def _naive_cem(draws, iterations, topk, init_std):
    """The CEM loop with torch's default (sample) std."""
    mean, std = torch.zeros(H, A), torch.full((H, A), init_std)
    for _, eps in draws[:iterations]:
        cand = mean[None] + std[None] * torch.from_numpy(eps)
        elites = cand[torch.topk(_port_rollout(cand, None), topk).indices]
        mean, std = elites.mean(0), elites.std(0) + 1e-6
    return mean


def test_cem_planner_matches_jax_with_population_std():
    from ode_rl_tpu.wm.planners import cem_planner as jcem

    key = jax.random.key(11)
    kw = dict(horizon=H, action_dim=A, iterations=5, proposals=64, topk=4,
              init_std=1.0)
    ref = np.asarray(jcem(_jax_rollout, key, **kw))
    draws = _cem_draws(key, 5, 64)
    ours = cem_planner(_port_rollout, DrawReplay(draws), **kw)
    assert max_abs(ours, ref) <= 1e-5
    assert max_abs(_naive_cem(draws, 5, 4, 1.0), ref) > 1e-2
    # The plan beats the first iteration's mean proposal.
    first = _rollout_np(draws[0][1]).mean()
    assert _rollout_np(ours.numpy()[None])[0] >= first


def test_grad_planner_matches_jax():
    from ode_rl_tpu.wm.planners import grad_planner as jgrad

    key = jax.random.key(12)
    kw = dict(horizon=H, action_dim=A, iterations=30, lr=0.05, init_std=0.1)
    ref = np.asarray(jgrad(_jax_rollout, key, **kw))
    k0, _ = jax.random.split(key)
    draws = [("normal", np.asarray(jax.random.normal(k0, (H, A)),
                                   np.float32))]
    ours = grad_planner(_port_rollout, DrawReplay(draws), **kw)
    assert max_abs(ours, ref) <= 1e-5
    start = 0.1 * draws[0][1]
    assert _rollout_np(ours.numpy()[None])[0] > _rollout_np(start[None])[0]


def test_planners_draw_from_a_generator():
    gen = torch.Generator().manual_seed(0)
    plan = cem_planner(_port_rollout, gen, H, A, iterations=8,
                       proposals=500, topk=50)
    assert plan.shape == (H, A) and torch.isfinite(plan).all()
    plan_g = grad_planner(_port_rollout, gen, H, A, iterations=100, lr=0.05)
    assert _rollout_np(plan_g.numpy()[None])[0] > _rollout_np(
        np.zeros((1, H, A), np.float32))[0]
    with pytest.raises(ValueError, match="generator"):
        cem_planner(_port_rollout, None, H, A)
