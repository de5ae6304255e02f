"""The actor-critic trained in the world model's imagination (DreamerV2's
ImagBehavior).

Counterpart of ``ode_rl_tpu/wm/behavior.py``:

* ``ActionHead``: Dense ``h{i}`` with the activation, then ``out`` ->
  logits ('onehot': a straight-through categorical) or [mean, raw std]
  ('tanh_normal': tanh of a Gaussian with std 2 sigmoid((raw +
  softplus^-1(init_std)) / 2) + min_std); ``sample``, ``mode``,
  ``log_prob`` (the action clipped to +-0.999, minus the tanh Jacobian
  log(1 - a^2)) and ``entropy`` (of the base Gaussian);
* ``ImagBehavior``: rollouts of ``horizon`` steps through the prior,
  lambda-return targets from a slow value copy (copied every
  ``slow_target_update`` updates), discount weights, the actor loss
  ('dynamics': backprop through the rollout; 'reinforce': the score
  function with a value baseline; 'both') with the entropy bonus, and
  the value regression to the stopped target. ``train_step`` updates the
  actor (global-norm clip, then Adam with eps 1e-5), then, from a
  second rollout with the updated actor, the value (likewise). The world
  model enters through ``img_step_fn(state, noise, action)``,
  ``get_feat_fn(state)`` and ``reward_fn(feats, states, actions)``; with
  'dynamics' the actor's gradient flows through its ``img_step``, and
  only the actor's and the value's parameters are differentiated, so
  the world model is not updated.

Draws, from the caller's ``Noise``: each imagined step draws the actor's
sample (a normal (B, A) for 'tanh_normal', a Gumbel for 'onehot'), then
``img_step_fn``'s. ``train_step`` makes the actor's rollout's draws, then
the value's. JAX's order: its key splits into the actor's and the
value's; each splits into one key a step, which splits into the
action's key and the transition's.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.core.noise import Noise, global_rows
from ode_rl_torch.nn.dense import Dense
from ode_rl_torch.parallel.mesh import Mesh, entered
from ode_rl_torch.wm.networks import ACTS, DenseHead
from ode_rl_torch.wm.rssm import stack
from ode_rl_torch.wm.tools import lambda_return, one_hot_st_sample
from ode_rl_torch.wm.world_model import ClippedOptimizer


class ActionHead(nn.Module):
    def __init__(self, feat_dim: int, action_dim: int, layers: int = 4,
                 units: int = 400, act: str = "elu", dist: str = "onehot",
                 init_std: float = 1.0, min_std: float = 0.1, *,
                 generator: torch.Generator):
        super().__init__()
        self.action_dim, self.layers, self.dist = action_dim, layers, dist
        self.init_std, self.min_std = init_std, min_std
        self.act = ACTS[act]
        din = feat_dim
        for i in range(layers):
            self.add_module(f"h{i}", Dense(din, units, generator=generator))
            din = units
        self.out = Dense(din, action_dim if dist == "onehot"
                         else 2 * action_dim, generator=generator)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """Features -> logits ('onehot') or [mean, raw std]."""
        x = features
        for i in range(self.layers):
            x = self.act(getattr(self, f"h{i}")(x))
        return self.out(x)

    def _split(self, stats: torch.Tensor):
        stats = stats.float()
        if self.dist == "onehot":
            return stats
        mean, raw = stats.chunk(2, dim=-1)
        raw_init = torch.log(torch.exp(torch.tensor(
            self.init_std, dtype=torch.float32)) - 1.0)
        std = 2.0 * torch.sigmoid((raw + raw_init.to(raw.device)) / 2.0)
        return mean, std + self.min_std

    def sample(self, stats: torch.Tensor, noise: Noise) -> torch.Tensor:
        if self.dist == "onehot":
            return one_hot_st_sample(noise, self._split(stats))
        mean, std = self._split(stats)
        return torch.tanh(mean + std * noise.normal(mean.shape, mean))

    def mode(self, stats: torch.Tensor) -> torch.Tensor:
        if self.dist == "onehot":
            return F.one_hot(torch.argmax(self._split(stats), -1),
                             self.action_dim).float()
        return torch.tanh(self._split(stats)[0])

    def log_prob(self, stats: torch.Tensor,
                 action: torch.Tensor) -> torch.Tensor:
        if self.dist == "onehot":
            lp = torch.log_softmax(self._split(stats), dim=-1)
            return torch.sum(lp * action.detach(), dim=-1)
        mean, std = self._split(stats)
        a = torch.clamp(action, -0.999, 0.999)
        base = (-0.5 * ((torch.atanh(a) - mean) / std) ** 2
                - torch.log(std) - 0.5 * math.log(2.0 * math.pi))
        return torch.sum(base - torch.log1p(-a * a), dim=-1)

    def entropy(self, stats: torch.Tensor) -> torch.Tensor:
        if self.dist == "onehot":
            lp = torch.log_softmax(self._split(stats), dim=-1)
            return -torch.sum(torch.exp(lp) * lp, dim=-1)
        _, std = self._split(stats)
        return torch.sum(0.5 * torch.log(2.0 * math.pi * math.e * std * std),
                         dim=-1)


def _adam(params, lr: float, clip: float) -> ClippedOptimizer:
    return ClippedOptimizer(torch.optim.Adam(params, lr=lr,
                                             betas=(0.9, 0.999), eps=1e-5),
                            clip)


class ImagBehavior(nn.Module):
    """The actor, the value and its slow copy, with their optimizers."""

    def __init__(self, action_dim: int, feat_dim: int,
                 actor_dist: str = "onehot", horizon: int = 15,
                 discount: float = 0.99, discount_lambda: float = 0.95,
                 actor_lr: float = 8e-5, value_lr: float = 8e-5,
                 actor_grad_clip: float = 100.0,
                 value_grad_clip: float = 100.0,
                 actor_entropy: float = 1e-4,
                 imag_gradient: str = "dynamics",
                 slow_target_update: int = 100, units: int = 400,
                 layers: int = 4, stop_grad_actor: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        if imag_gradient not in ("dynamics", "reinforce", "both"):
            raise NotImplementedError(imag_gradient)
        self.actor = ActionHead(feat_dim, action_dim, layers, units,
                                dist=actor_dist, generator=generator)
        self.value = DenseHead(feat_dim, (), layers, units,
                               generator=generator)
        self.slow_value = copy.deepcopy(self.value).requires_grad_(False)
        self.horizon, self.discount = horizon, discount
        self.discount_lambda, self.actor_entropy = (discount_lambda,
                                                    actor_entropy)
        self.imag_gradient = imag_gradient
        self.slow_target_update = slow_target_update
        self.stop_grad_actor = stop_grad_actor
        self.actor_lr, self.value_lr = actor_lr, value_lr
        self.actor_grad_clip, self.value_grad_clip = (actor_grad_clip,
                                                      value_grad_clip)
        self.updates = 0
        self.actor_opt = self.value_opt = None

    def _actor_input(self, feat: torch.Tensor) -> torch.Tensor:
        return feat.detach() if self.stop_grad_actor else feat

    def imagine(self, start_state: Dict, img_step_fn: Callable,
                get_feat_fn: Callable, noise: Noise
                ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
        """The policy's rollout through the prior: (H, B, F) features,
        (H, B, ...) states and (H, B, A) actions, each step's state the
        one its action was taken in."""
        state = start_state
        states: List[Dict] = []
        feats, actions = [], []
        for _ in range(self.horizon):
            feat = get_feat_fn(state)
            action = self.actor.sample(self.actor(self._actor_input(feat)),
                                       noise)
            states.append(state)
            feats.append(feat)
            actions.append(action)
            state = img_step_fn(state, noise, action)
        return (torch.stack(feats), stack(states, dim=0),
                torch.stack(actions))

    def _compute_target(self, feats: torch.Tensor, reward: torch.Tensor):
        value = self.slow_value(feats)
        discount = self.discount * torch.ones_like(reward)
        target = lambda_return(reward[:-1], value[:-1], discount[:-1],
                               bootstrap=value[-1],
                               lambda_=self.discount_lambda, axis=0)
        weights = torch.cumprod(torch.cat(
            [torch.ones_like(discount[:1]), discount[:-1]], 0), 0).detach()
        return target, weights

    def loss(self, start_state: Dict, img_step_fn: Callable,
             get_feat_fn: Callable, reward_fn: Callable, noise: Noise,
             rollout_grad: bool = True):
        """(actor loss, value loss, metrics) of one rollout; without
        ``rollout_grad`` the rollout and its rewards keep no graph (the
        value loss's gradient does not pass through them)."""
        with torch.set_grad_enabled(rollout_grad):
            feats, states, actions = self.imagine(start_state, img_step_fn,
                                                  get_feat_fn, noise)
            reward = reward_fn(feats, states, actions).float()
        stats = self.actor(self._actor_input(feats))
        ent = self.actor.entropy(stats)
        target, weights = self._compute_target(feats, reward)
        if self.imag_gradient == "dynamics":
            actor_target = target
        else:
            adv = (target - self.value(feats[:-1])).detach()
            reinforce = self.actor.log_prob(stats,
                                            actions.detach())[:-1] * adv
            actor_target = (reinforce if self.imag_gradient == "reinforce"
                            else 0.5 * target + 0.5 * reinforce)
        actor_target = actor_target + self.actor_entropy * ent[:-1]
        actor_loss = -torch.mean(weights[:-1] * actor_target)
        value_pred = self.value(feats[:-1])
        value_loss = torch.mean(weights[:-1]
                                * (value_pred - target.detach()) ** 2)
        metrics = {"actor_loss": actor_loss.detach(),
                   "value_loss": value_loss.detach(),
                   "reward_mean": reward.mean().detach(),
                   "actor_ent": ent.mean().detach(),
                   "target_mean": target.mean().detach()}
        return actor_loss, value_loss, metrics

    def train_step(self, start_state: Dict, img_step_fn: Callable,
                   get_feat_fn: Callable, reward_fn: Callable,
                   noise: Noise, mesh: Optional[Mesh] = None) -> Dict:
        """One update of the actor, then of the value, then the slow
        target's copy where due; returns the actor rollout's metrics.
        Under a ``mesh`` ``start_state`` holds this rank's rows, the
        rollout's draws are its rows of the global ones, each gradient is
        averaged over the ranks before its clip, and the metrics are the
        global batch's."""
        if mesh is not None:
            noise = global_rows(noise, mesh.rank, mesh.world)
        with entered(mesh):
            metrics = self._train_step(start_state, img_step_fn, get_feat_fn,
                                       reward_fn, noise, mesh)
        return metrics if mesh is None else mesh.mean_metrics(metrics)

    def _train_step(self, start_state, img_step_fn, get_feat_fn, reward_fn,
                    noise, mesh) -> Dict:
        if self.actor_opt is None:
            # Over the parameters where they now are (after ``.to``).
            self.actor_opt = _adam(self.actor.parameters(), self.actor_lr,
                                   self.actor_grad_clip)
            self.value_opt = _adam(self.value.parameters(), self.value_lr,
                                   self.value_grad_clip)
        actor_loss, _, metrics = self.loss(start_state, img_step_fn,
                                           get_feat_fn, reward_fn, noise)
        _set_grads(actor_loss, self.actor_opt.params, mesh)
        self.actor_opt.step()
        _, value_loss, _ = self.loss(start_state, img_step_fn, get_feat_fn,
                                     reward_fn, noise, rollout_grad=False)
        _set_grads(value_loss, self.value_opt.params, mesh)
        self.value_opt.step()
        self.updates += 1
        if self.updates % self.slow_target_update == 0:
            self.slow_value.load_state_dict(self.value.state_dict())
        return metrics


def _set_grads(loss: torch.Tensor, params: List[torch.Tensor],
               mesh: Optional[Mesh] = None) -> None:
    """``.grad`` of ``params`` from ``loss``, and of nothing else
    (averaged over the ``mesh``'s ranks)."""
    for p, g in zip(params, torch.autograd.grad(loss, params,
                                                allow_unused=True)):
        p.grad = torch.zeros_like(p) if g is None else g
    if mesh is not None:
        mesh.all_reduce_grads(params)


def rssm_behavior_fns(rssm) -> Tuple[Callable, Callable]:
    """(img_step_fn, get_feat_fn) over a world model's RSSM."""

    def img_step_fn(state, noise, action):
        return rssm.img_step(state, noise, action=action)

    return img_step_fn, rssm.get_feat
