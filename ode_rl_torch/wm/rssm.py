"""The recurrent state-space model (RSSM).

Counterpart of ``ode_rl_tpu/wm/rssm.py``: a deterministic state (a GRU
over the previous stochastic state and, optionally, an action) and a
stochastic one, Gaussian (``mean_act`` none or tanh5, ``std_act``
softplus, abs, sigmoid or sigmoid2, plus ``min_std``) or ``stoch``
factors of ``discrete`` classes sampled one-hot with a straight-through
gradient; the posterior from [deter, embed] (``temp_post``);
``observe``, ``imagine``, ``entropy`` and the balanced KL with free
bits.

``NormGRUCell`` is one Dense ``fused`` of width 3 * size over [x,
state], LayerNorm ``norm`` in fp32 (epsilon 1e-6), split **reset,
candidate, update** (not torch's GRU order), update bias -1:

    r = sigmoid(reset); c = tanh(r * cand); u = sigmoid(update - 1)
    h' = u * c + (1 - u) * h.

Parameters keep JAX's names (``ini{i}``, ``imo{i}``, ``obi{i}``,
``ims``, ``obs``, ``cell/fused``, ``cell/norm``), so ``convert.py``
carries JAX's trees. JAX's restructurings of ``observe`` (the embed-side
half of ``obi0`` hoisted out of the scan, ``imo0`` merged with the
posterior's deter-side matmul, the noise drawn before the scan) compute
the same function as the plain per-step ``obs_step`` here.

Draws, from the caller's ``Noise``: ``obs_step`` draws the prior's
sample, then the posterior's; ``observe`` does so for t = 0, 1, ...;
``imagine`` draws one prior sample a step. A Gaussian sample is one
standard normal (B, stoch), a discrete one a Gumbel (B, stoch,
discrete) added to the logits before the argmax. This is JAX's order:
there key_t (``split(key, T)[t]``) splits into a prior key and a
posterior key, each drawing one such array; in ``imagine`` key_t draws
the step's. With ``sample=False`` nothing is drawn (the mean, or the
argmax's one-hot).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.core.noise import Noise
from ode_rl_torch.nn.dense import Dense
from ode_rl_torch.nn.norm import LayerNorm
from ode_rl_torch.parallel.mesh import global_mean
from ode_rl_torch.wm.networks import ACTS

State = Dict[str, torch.Tensor]

_MEAN_ACTS = {"none": lambda m: m,
              "tanh5": lambda m: 5.0 * torch.tanh(m / 5.0)}
_STD_ACTS = {"softplus": F.softplus,
             "abs": lambda s: torch.abs(s + 1.0),
             "sigmoid": torch.sigmoid,
             "sigmoid2": lambda s: 2.0 * torch.sigmoid(s / 2.0)}


class NormGRUCell(nn.Module):
    def __init__(self, din: int, size: int, norm: bool = True,
                 update_bias: float = -1.0, *, generator: torch.Generator):
        super().__init__()
        self.update_bias = update_bias
        self.fused = Dense(din + size, 3 * size, use_bias=norm,
                           generator=generator)
        self.norm = LayerNorm(3 * size) if norm else None

    def forward(self, x: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        parts = self.fused(torch.cat([x, state], dim=-1))
        if self.norm is not None:
            parts = self.norm(parts.float()).to(parts.dtype)
        reset, cand, update = parts.chunk(3, dim=-1)
        reset = torch.sigmoid(reset)
        cand = torch.tanh(reset * cand)
        update = torch.sigmoid(update + self.update_bias)
        return update * cand + (1.0 - update) * state


def detach(state: State) -> State:
    return {k: v.detach() for k, v in state.items()}


def stack(states, dim: int = 1) -> State:
    """A list of states -> one state with a new axis ``dim``."""
    return {k: torch.stack([s[k] for s in states], dim=dim)
            for k in states[0]}


class RSSM(nn.Module):
    def __init__(self, embed_dim: int, stoch: int = 30, deter: int = 200,
                 hidden: int = 200, layers_input: int = 1,
                 layers_output: int = 1, rec_depth: int = 1,
                 discrete: int = 0, act: str = "elu", mean_act: str = "none",
                 std_act: str = "softplus", temp_post: bool = True,
                 min_std: float = 0.1, cell_norm: bool = True,
                 action_dim: int = 0, *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.stoch, self.deter, self.hidden = stoch, deter, hidden
        self.layers_input, self.layers_output = layers_input, layers_output
        self.rec_depth, self.discrete = rec_depth, discrete
        self.act = ACTS[act]
        self.mean_act, self.std_act = _MEAN_ACTS[mean_act], _STD_ACTS[std_act]
        self.temp_post, self.min_std, self.dtype = temp_post, min_std, dtype
        kw = dict(generator=generator)
        self.stoch_flat = stoch * discrete if discrete else stoch
        din = self.stoch_flat + action_dim
        for i in range(layers_input):
            self.add_module(f"ini{i}", Dense(din, hidden, **kw))
            din = hidden
        for i in range(layers_output):
            self.add_module(f"imo{i}", Dense(deter if i == 0 else hidden,
                                             hidden, **kw))
        din = deter + embed_dim if temp_post else embed_dim
        for i in range(max(layers_output, 1)):
            self.add_module(f"obi{i}", Dense(din, hidden, **kw))
            din = hidden
        stats = stoch * discrete if discrete else 2 * stoch
        self.ims = Dense(hidden if layers_output else deter, stats, **kw)
        self.obs = Dense(hidden, stats, **kw)
        self.cell = NormGRUCell(hidden, deter, norm=cell_norm, **kw)

    # ------------------------------------------------------------------
    def initial(self, batch: int, device: torch.device) -> State:
        z = lambda *shape: torch.zeros(shape, dtype=self.dtype,
                                       device=device)
        if self.discrete:
            return {"logit": z(batch, self.stoch, self.discrete),
                    "stoch": z(batch, self.stoch, self.discrete),
                    "deter": z(batch, self.deter)}
        return {"mean": z(batch, self.stoch), "std": z(batch, self.stoch),
                "stoch": z(batch, self.stoch), "deter": z(batch, self.deter)}

    def get_feat(self, state: State) -> torch.Tensor:
        stoch = state["stoch"]
        if self.discrete:
            stoch = stoch.reshape(*stoch.shape[:-2], self.stoch_flat)
        return torch.cat([stoch, state["deter"]], dim=-1)

    def _stats(self, layer: nn.Module, x: torch.Tensor) -> State:
        x = layer(x)
        if self.discrete:
            return {"logit": x.reshape(*x.shape[:-1], self.stoch,
                                       self.discrete)}
        mean, std = x.chunk(2, dim=-1)
        return {"mean": self.mean_act(mean),
                "std": self.std_act(std) + self.min_std}

    def _sample(self, stats: State, noise: Optional[Noise],
                sample: bool) -> torch.Tensor:
        if self.discrete:
            logit = stats["logit"]
            if not sample:
                return F.one_hot(torch.argmax(logit, -1),
                                 self.discrete).to(logit.dtype)
            idx = torch.argmax(logit + noise.gumbel(logit.shape, logit), -1)
            probs = torch.softmax(logit, dim=-1)
            return (F.one_hot(idx, self.discrete).to(logit.dtype) + probs
                    - probs.detach())
        if not sample:
            return stats["mean"]
        mean = stats["mean"]
        return mean + stats["std"] * noise.normal(mean.shape, mean)

    def _trunk(self, prefix: str, x: torch.Tensor, n: int) -> torch.Tensor:
        for i in range(n):
            x = self.act(getattr(self, f"{prefix}{i}")(x))
        return x

    # ------------------------------------------------------------------
    def img_step(self, prev_state: State, noise: Optional[Noise],
                 sample: bool = True,
                 action: Optional[torch.Tensor] = None) -> State:
        """The prior transition, optionally conditioned on ``action``
        (B, A)."""
        x = prev_state["stoch"]
        if self.discrete:
            x = x.reshape(*x.shape[:-2], self.stoch_flat)
        if action is not None:
            x = torch.cat([x, action.to(x.dtype)], dim=-1)
        x = self._trunk("ini", x, self.layers_input)
        deter = prev_state["deter"]
        for _ in range(self.rec_depth):
            deter = self.cell(x, deter)
            x = deter
        x = self._trunk("imo", deter, self.layers_output)
        stats = self._stats(self.ims, x)
        return {"stoch": self._sample(stats, noise, sample), "deter": deter,
                **stats}

    def obs_step(self, prev_state: State, embed: torch.Tensor,
                 noise: Optional[Noise], sample: bool = True,
                 action: Optional[torch.Tensor] = None
                 ) -> Tuple[State, State]:
        prior = self.img_step(prev_state, noise, sample, action=action)
        x = (torch.cat([prior["deter"], embed.to(prior["deter"].dtype)], -1)
             if self.temp_post else embed)
        x = self._trunk("obi", x, max(self.layers_output, 1))
        stats = self._stats(self.obs, x)
        post = {"stoch": self._sample(stats, noise, sample),
                "deter": prior["deter"], **stats}
        return post, prior

    def observe(self, embed: torch.Tensor, noise: Optional[Noise],
                state: Optional[State] = None,
                actions: Optional[torch.Tensor] = None
                ) -> Tuple[State, State]:
        """embed (B, T, E) -> (post, prior) with (B, T, ...) leaves;
        ``actions`` (B, T, A), action_t preceding obs_t."""
        if state is None:
            state = self.initial(embed.shape[0], embed.device)
        posts, priors = [], []
        for t in range(embed.shape[1]):
            state, prior = self.obs_step(
                state, embed[:, t], noise,
                action=None if actions is None else actions[:, t])
            posts.append(state)
            priors.append(prior)
        return stack(posts), stack(priors)

    def imagine(self, n_steps: int, state: State,
                noise: Optional[Noise]) -> State:
        """The open-loop prior rollout of ``n_steps`` from ``state``."""
        priors = []
        for _ in range(n_steps):
            state = self.img_step(state, noise)
            priors.append(state)
        return stack(priors)

    # ------------------------------------------------------------------
    def entropy(self, state: State) -> torch.Tensor:
        """The latent distribution's entropy, summed over factors."""
        if self.discrete:
            lp = torch.log_softmax(state["logit"].float(), dim=-1)
            return -torch.sum(torch.exp(lp) * lp, dim=(-2, -1))
        std = state["std"].float()
        return torch.sum(0.5 * torch.log(2 * math.pi * math.e * std ** 2),
                         dim=-1)

    def _kl(self, post: State, prior: State) -> torch.Tensor:
        """KL(post || prior) per sample, fp32."""
        if self.discrete:
            lp = torch.log_softmax(post["logit"].float(), dim=-1)
            lq = torch.log_softmax(prior["logit"].float(), dim=-1)
            return torch.sum(torch.exp(lp) * (lp - lq), dim=(-2, -1))
        mp, sp = post["mean"].float(), post["std"].float()
        mq, sq = prior["mean"].float(), prior["std"].float()
        kl = (torch.log(sq / sp) + (sp ** 2 + (mp - mq) ** 2) / (2 * sq ** 2)
              - 0.5)
        return kl.sum(dim=-1)

    def kl_loss(self, post: State, prior: State, forward: bool = False,
                balance: float = 0.8, free: float = 1.0,
                scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
        """The balanced KL with free bits: (loss, KL per sample)."""
        lhs, rhs = (prior, post) if forward else (post, prior)
        mix = balance if forward else 1.0 - balance
        value = self._kl(lhs, rhs)
        if balance == 0.5:
            loss = torch.clamp(value, min=free).mean()
        else:
            # Free bits clamp the global batch's mean (parallel/mesh.py).
            loss_lhs = torch.clamp(global_mean(self._kl(lhs, detach(rhs))),
                                   min=free)
            loss_rhs = torch.clamp(global_mean(self._kl(detach(lhs), rhs)),
                                   min=free)
            loss = mix * loss_lhs + (1.0 - mix) * loss_rhs
        return loss * scale, value
