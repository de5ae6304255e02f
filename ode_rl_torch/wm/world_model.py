"""The Dreamer world model for video prediction and for the RL loop.

Counterpart of ``ode_rl_tpu/wm/world_model.py``: ``ConvEncoder`` -> the
RSSM's ``observe`` (optionally action-conditioned) -> the image head
(Normal(mean, 1) log-likelihood, summed over the frame) and the optional
reward ('normal') and discount ('binary') heads, plus the balanced KL
with the scheduled balance, free bits and scale. The metrics are
``loss``, ``kl_loss``, ``kl``, ``prior_ent``, ``post_ent``, ``kl_free``,
``kl_scale`` and ``<head>_loss``; ``return_features`` adds the posterior
features under ``_features`` (the CATER classifier's input).

``DreamerVideoModel`` is the model of the ``Dreamer`` blocks: its loss
runs over the observed frames followed by the frames to predict, and its
``predict`` is the open-loop ``video_pred`` conditioned on the observed
frames. As in JAX, the generic train step calls ``loss`` without a
step, so the KL schedules are read at step 0, and the blocks train with
the generic step's Adam; ``world_model_optimizer`` (the CATER
classifier's and the RL demo's) is a global-norm clip at 100, then
``adamw(lr, eps=1e-5, weight_decay=1e-6)``: torch's ``AdamW`` with the
same eps and decay is optax's (decoupled decay -lr * wd * p, eps outside
the square root).

Draws, from the caller's generator: the RSSM's (wm/rssm.py), in the
order ``observe`` makes them; ``video_pred`` draws ``observe``'s over all
frames, then ``imagine``'s (JAX splits its key into these two).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ode_rl_torch.core.noise import as_noise
from ode_rl_torch.train.step import clip_by_global_norm, global_norm
from ode_rl_torch.wm.networks import (ConvDecoder, ConvEncoder, DenseHead,
                                      encoder_size)
from ode_rl_torch.wm.rssm import RSSM
from ode_rl_torch.wm.tools import schedule


def image_log_prob(mean: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """log N(image; mean, 1) summed over each frame (H, W, C)."""
    d = mean.float() - image.float()
    return torch.sum(-0.5 * (math.log(2 * math.pi) + d * d), dim=(-3, -2, -1))


class WorldModel(nn.Module):
    def __init__(self, image_shape: Tuple[int, int, int] = (64, 64, 1),
                 cnn_depth: int = 32, stoch: int = 30, deter: int = 200,
                 hidden: int = 200, discrete: int = 0,
                 mean_act: str = "none", std_act: str = "sigmoid2",
                 min_std: float = 0.1, cell_norm: bool = True,
                 kl_balance=0.8, kl_free=1.0, kl_scale=1.0,
                 kl_forward: bool = False, pred_discount: bool = False,
                 discount_scale: float = 1.0, pred_reward: bool = False,
                 action_dim: int = 0, *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(generator=generator)
        self.image_shape, self.dtype = tuple(image_shape), dtype
        self.stoch, self.deter, self.discrete = stoch, deter, discrete
        self.kl_balance, self.kl_free, self.kl_scale = (kl_balance, kl_free,
                                                        kl_scale)
        self.kl_forward, self.discount_scale = kl_forward, discount_scale
        self.pred_discount, self.pred_reward = pred_discount, pred_reward
        self.encoder = ConvEncoder(image_shape[-1], cnn_depth, dtype=dtype,
                                   **kw)
        self.dynamics = RSSM(
            encoder_size(self.image_shape, cnn_depth), stoch=stoch,
            deter=deter, hidden=hidden, discrete=discrete,
            mean_act=mean_act, std_act=std_act, min_std=min_std,
            cell_norm=cell_norm, action_dim=action_dim, dtype=dtype, **kw)
        self.feat_dim = stoch * max(discrete, 1) + deter
        self.image_head = ConvDecoder(self.feat_dim, cnn_depth,
                                      shape=self.image_shape, dtype=dtype,
                                      **kw)
        if pred_discount:
            self.discount_head = DenseHead(self.feat_dim, (), 4, 400,
                                           dist="binary", **kw)
        if pred_reward:
            self.reward_head = DenseHead(self.feat_dim, (), 4, 400, **kw)

    # ------------------------------------------------------------------
    def loss(self, batch: Dict[str, torch.Tensor], generator=None,
             step: int = 0, return_features: bool = False):
        """batch['image'] (B, T, H, W, C) in [-0.5, 0.5] (with optional
        'action', 'reward', 'discount') -> (loss, (metrics, the image
        means))."""
        noise = as_noise(generator, "WorldModel")
        image = batch["image"].to(self.dtype)
        embed = self.encoder(image)
        post, prior = self.dynamics.observe(embed, noise,
                                            actions=batch.get("action"))
        kl_free = schedule(self.kl_free, step)
        kl_scale = schedule(self.kl_scale, step)
        balance = (self.kl_balance if isinstance(self.kl_balance, float)
                   else 0.8)
        kl_loss, kl_value = self.dynamics.kl_loss(
            post, prior, self.kl_forward, balance, kl_free, kl_scale)
        feat = self.dynamics.get_feat(post)
        mean = self.image_head(feat)
        losses = {"image": -torch.mean(image_log_prob(mean, image))}
        if self.pred_discount and "discount" in batch:
            lp = self.discount_head.log_prob(self.discount_head(feat),
                                             batch["discount"])
            losses["discount"] = -torch.mean(lp) * self.discount_scale
        if self.pred_reward and "reward" in batch:
            lp = self.reward_head.log_prob(self.reward_head(feat),
                                           batch["reward"])
            losses["reward"] = -torch.mean(lp)
        model_loss = sum(losses.values()) + kl_loss
        metrics = {
            "loss": model_loss, "kl_loss": kl_loss, "kl": kl_value.mean(),
            "prior_ent": self.dynamics.entropy(prior).mean(),
            "post_ent": self.dynamics.entropy(post).mean(),
            "kl_free": kl_free, "kl_scale": kl_scale,
            **{f"{k}_loss": v for k, v in losses.items()}}
        if return_features:
            metrics["_features"] = feat
        return model_loss, (metrics, mean.float())

    def observe_features(self, image: torch.Tensor,
                         generator=None) -> torch.Tensor:
        """(B, T, H, W, C) in [-0.5, 0.5] -> (B, T, F) posterior
        features."""
        noise = as_noise(generator, "WorldModel")
        post, _ = self.dynamics.observe(self.encoder(image.to(self.dtype)),
                                        noise)
        return self.dynamics.get_feat(post)

    def video_pred(self, batch: Dict[str, torch.Tensor], generator=None,
                   initial_frames: int = 10) -> Dict[str, torch.Tensor]:
        """Condition on the first ``initial_frames`` and imagine the rest:
        truth, reconstruction and imagined frames in [0, 1]."""
        noise = as_noise(generator, "WorldModel")
        image = batch["image"].to(self.dtype)
        t = image.shape[1]
        initial_frames = min(initial_frames, t - 1)
        post, _ = self.dynamics.observe(self.encoder(image), noise)
        recon = self.image_head(self.dynamics.get_feat(post))
        init = {k: v[:, initial_frames - 1] for k, v in post.items()}
        prior = self.dynamics.imagine(t - initial_frames, init, noise)
        openl = self.image_head(self.dynamics.get_feat(prior))
        imagined = torch.cat([recon[:, :initial_frames], openl], dim=1)
        return {"truth": image.float() + 0.5, "recon": recon.float() + 0.5,
                "imagined": imagined.float() + 0.5}

    def predict(self, batch: Dict[str, torch.Tensor], generator=None):
        _, (metrics, pred) = self.loss(batch, generator)
        return pred + 0.5, {k: v for k, v in metrics.items() if k != "loss"}


def _video(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([batch["observed_data"], batch["data_to_predict"]],
                     dim=1)


class DreamerVideoModel(WorldModel):
    def loss(self, batch: Dict[str, torch.Tensor], generator=None,
             step: int = 0, return_features: bool = False):
        if "image" not in batch:
            batch = {"image": _video(batch)}
        return WorldModel.loss(self, batch, generator, step, return_features)

    def predict(self, batch: Dict[str, torch.Tensor], generator=None):
        """The open-loop prediction of the frames to predict, in [0, 1]."""
        n_in = batch["observed_data"].shape[1]
        out = self.video_pred({"image": _video(batch)}, generator,
                              initial_frames=n_in)
        return out["imagined"][:, n_in:], {}


class ClippedOptimizer:
    """optax's ``chain(clip_by_global_norm(clip), <optimizer>)`` over the
    gradients in ``.grad``: the global norm of the raw gradients, the
    clip, then the optimizer's step."""

    def __init__(self, optimizer: torch.optim.Optimizer, clip: float):
        self.optimizer, self.clip = optimizer, clip
        self.params = [p for g in optimizer.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip and step; returns the raw gradients' global norm."""
        params = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        for p, g in zip(params, clip_by_global_norm(grads, norm, self.clip)):
            p.grad = g
        self.optimizer.step()
        return norm


def world_model_optimizer(params, lr: float = 3e-4, eps: float = 1e-5,
                          clip: float = 100.0, wd: float = 1e-6
                          ) -> ClippedOptimizer:
    """A global-norm clip, then ``adamw(lr, eps, weight_decay=wd)``."""
    return ClippedOptimizer(torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=eps, weight_decay=wd), clip)
