"""The spatial RSSM: latent state as a feature map (ModelBasedRL_TF_V2).

Counterpart of ``ode_rl_tpu/wm/spatial_rssm.py``. Maps are NHWC.

* ``StochasticConvGRUCell``: a ConvGRU of three orthogonally initialised
  5x5 'SAME' convs ``update``, ``reset`` (biases ones) and ``out``
  (bias zeros) makes the candidate h~; a per-channel gate head,
  ``update_u1`` (Dense 8 over each channel's pixels, in (h, w)
  row-major order, as JAX's ``moveaxis(h, -1, 1).reshape(b, c, H W)``)
  and ``update_u2`` (Dense C over the flattened (C, 8)), gives
  p~ = sigmoid(.); the skip accumulation
  p' = u p~ + (1 - u)(p + min(1 - p, p~)); a straight-through Bernoulli
  sample u' = [v < p'] + p' - p'.detach() of one uniform v; and
  h' = u' h~ + (1 - u') h per channel. Without noise the sample is the
  probability p'. Returns (h', u', p', p~).
* ``TFConvGRUCell``: the same ConvGRU with zero biases and no gate.
* ``SpatialRSSM``: a 3x3 ``in_conv`` over the stochastic map, the cell,
  3x3 ``ims`` and ``obs`` stats convs (softplus std + ``min_std``);
  ``observe``, ``imagine``, the KL with free bits and the gate-sparsity
  Bernoulli KL against a fixed prior.
* ``SpatialWorldModel``: 4x4 stride-2 'SAME' encoder convs ``enc1``,
  ``enc2`` to maps of a quarter of the frame, the RSSM, the port's 4x4
  'SAME' transposed convs ``dec1``, ``dec2``; its loss is the image NLL
  plus ``kl_scale`` times the KL plus the sparsity term, and it raises
  ``ValueError`` on frames of another shape than it was built for.

Draws, from the caller's ``Noise``: ``img_step`` draws the gate's
uniform (B, C) (where the gates are stochastic), then the prior's normal
(B, h, w, stoch); ``obs_step`` draws the prior's, then the posterior's
normal; ``observe`` and ``imagine`` step by step. This is JAX's order:
key_t = ``split(key, T)[t]``; ``obs_step`` splits key_t into k1 (the
prior) and k2 (the posterior); ``img_step`` splits its key into the
gate's uniform and the normal. ``predict`` draws ``observe``'s, then
``imagine``'s (JAX splits its key into these two).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.core.noise import Noise, as_noise
from ode_rl_torch.nn.conv_stacks import Conv, ConvTranspose
from ode_rl_torch.nn.dense import Dense
from ode_rl_torch.parallel.mesh import global_mean
from ode_rl_torch.wm.rssm import stack
from ode_rl_torch.wm.world_model import image_log_prob

State = Dict[str, torch.Tensor]


def _orthogonal_conv(cin: int, cout: int, k: int, bias: float,
                     dtype: torch.dtype, generator: torch.Generator) -> Conv:
    """A k x k 'SAME' conv whose kernel, as flax's (k k cin, cout) matrix,
    has orthonormal columns (``nn.initializers.orthogonal()``)."""
    conv = Conv(cin, cout, k, padding=k // 2, dtype=dtype,
                generator=generator)
    w = torch.empty(k * k * cin, cout)
    nn.init.orthogonal_(w, generator=generator)
    with torch.no_grad():
        conv.weight.copy_(w.reshape(k, k, cin, cout).permute(3, 2, 0, 1))
        conv.bias.fill_(bias)
    return conv


def _conv_gru(cell: nn.Module, h: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    stacked = torch.cat([x, h], dim=-1)
    update = torch.sigmoid(cell.update(stacked))
    reset = torch.sigmoid(cell.reset(stacked))
    cand = torch.tanh(cell.out(torch.cat([x, h * reset], dim=-1)))
    return update * cand + (1.0 - update) * h


class StochasticConvGRUCell(nn.Module):
    def __init__(self, cin: int, hidden_dim: int, pixels: int,
                 kernel_size: int = 5, embed_dim: int = 8, skip: bool = True,
                 *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        c, k = cin + hidden_dim, kernel_size
        self.update = _orthogonal_conv(c, hidden_dim, k, 1.0, **kw)
        self.reset = _orthogonal_conv(c, hidden_dim, k, 1.0, **kw)
        self.out = _orthogonal_conv(c, hidden_dim, k, 0.0, **kw)
        self.update_u1 = Dense(pixels, embed_dim, generator=generator)
        self.update_u2 = Dense(hidden_dim * embed_dim, hidden_dim,
                               generator=generator)
        self.embed_dim, self.skip = embed_dim, skip

    def forward(self, h: torch.Tensor, u_sample: torch.Tensor,
                u_prob: torch.Tensor, x: torch.Tensor,
                noise: Optional[Noise] = None):
        h_tilde = _conv_gru(self, h, x)
        b, s1, s2, c = h_tilde.shape
        rows = h_tilde.permute(0, 3, 1, 2).reshape(b, c, s1 * s2)
        e = self.update_u1(rows)
        p_tilde = torch.sigmoid(self.update_u2(
            e.reshape(b, c * self.embed_dim)))
        if self.skip:
            new_u_prob = (u_sample * p_tilde + (1.0 - u_sample)
                          * (u_prob + torch.minimum(1.0 - u_prob, p_tilde)))
        else:
            new_u_prob = p_tilde
        if noise is None:
            new_u_sample = new_u_prob
        else:
            u = noise.uniform(new_u_prob.shape, new_u_prob.device).to(
                new_u_prob.dtype)
            hard = (u < new_u_prob).to(new_u_prob.dtype)
            new_u_sample = hard + new_u_prob - new_u_prob.detach()
        gate = new_u_sample[:, None, None, :]
        h_next = gate * h_tilde + (1.0 - gate) * h
        return h_next, new_u_sample, new_u_prob, p_tilde


class TFConvGRUCell(nn.Module):
    def __init__(self, cin: int, hidden_dim: int, kernel_size: int = 5, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        c, k = cin + hidden_dim, kernel_size
        self.update = _orthogonal_conv(c, hidden_dim, k, 0.0, **kw)
        self.reset = _orthogonal_conv(c, hidden_dim, k, 0.0, **kw)
        self.out = _orthogonal_conv(c, hidden_dim, k, 0.0, **kw)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return _conv_gru(self, h, x)


class SpatialRSSM(nn.Module):
    def __init__(self, embed_ch: int, stoch_ch: int = 16, deter_ch: int = 64,
                 hidden_ch: int = 64, latent_hw: int = 16,
                 min_std: float = 0.1, stochastic_gates: bool = False, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.stoch_ch, self.deter_ch, self.latent_hw = (stoch_ch, deter_ch,
                                                        latent_hw)
        self.min_std, self.stochastic_gates = min_std, stochastic_gates
        self.dtype = dtype
        self.in_conv = Conv(stoch_ch, hidden_ch, 3, padding=1, **kw)
        self.cell = (StochasticConvGRUCell(hidden_ch, deter_ch,
                                           latent_hw ** 2, **kw)
                     if stochastic_gates else
                     TFConvGRUCell(hidden_ch, deter_ch, **kw))
        self.ims = Conv(deter_ch, 2 * stoch_ch, 3, padding=1, **kw)
        self.obs = Conv(deter_ch + embed_ch, 2 * stoch_ch, 3, padding=1, **kw)

    def initial(self, batch: int, device: torch.device) -> State:
        hw = self.latent_hw
        z = lambda *shape: torch.zeros(shape, dtype=self.dtype,
                                       device=device)
        state = {"mean": z(batch, hw, hw, self.stoch_ch),
                 "std": z(batch, hw, hw, self.stoch_ch),
                 "stoch": z(batch, hw, hw, self.stoch_ch),
                 "deter": z(batch, hw, hw, self.deter_ch)}
        if self.stochastic_gates:
            state.update(u_sample=z(batch, self.deter_ch),
                         u_prob=z(batch, self.deter_ch),
                         u_logit=z(batch, self.deter_ch))
        return state

    def get_feat(self, state: State) -> torch.Tensor:
        return torch.cat([state["stoch"], state["deter"]], dim=-1)

    def _stats(self, layer: nn.Module, x: torch.Tensor,
               noise: Noise) -> State:
        mean, std_raw = layer(x).chunk(2, dim=-1)
        std = F.softplus(std_raw) + self.min_std
        return {"stoch": mean + std * noise.normal(mean.shape, mean),
                "mean": mean, "std": std}

    def img_step(self, prev: State, noise: Noise
                 ) -> Tuple[State, torch.Tensor]:
        x = self.in_conv(prev["stoch"])
        if self.stochastic_gates:
            deter, u_sample, u_prob, u_logit = self.cell(
                prev["deter"], prev["u_sample"], prev["u_prob"], x, noise)
            gate_mean = u_logit.mean()
        else:
            deter = self.cell(prev["deter"], x)
            gate_mean = torch.zeros((), dtype=self.dtype, device=x.device)
        prior = {"deter": deter, **self._stats(self.ims, deter, noise)}
        if self.stochastic_gates:
            prior.update(u_sample=u_sample, u_prob=u_prob, u_logit=u_logit)
        return prior, gate_mean

    def obs_step(self, prev: State, embed: torch.Tensor, noise: Noise
                 ) -> Tuple[State, State, torch.Tensor]:
        prior, gate_mean = self.img_step(prev, noise)
        x = torch.cat([prior["deter"], embed], dim=-1)
        post = {"deter": prior["deter"], **self._stats(self.obs, x, noise)}
        if self.stochastic_gates:
            post.update({k: prior[k] for k in ("u_sample", "u_prob",
                                               "u_logit")})
        return post, prior, gate_mean

    def observe(self, embed: torch.Tensor, noise: Noise,
                state: Optional[State] = None):
        """embed (B, T, h, w, C) -> (post, prior, the mean gate
        activation over the steps)."""
        if state is None:
            state = self.initial(embed.shape[0], embed.device)
        posts, priors, gates = [], [], []
        for t in range(embed.shape[1]):
            state, prior, g = self.obs_step(state, embed[:, t], noise)
            posts.append(state)
            priors.append(prior)
            gates.append(g)
        return stack(posts), stack(priors), torch.stack(gates).mean()

    def imagine(self, t: int, state: State, noise: Noise) -> State:
        priors = []
        for _ in range(t):
            state, _ = self.img_step(state, noise)
            priors.append(state)
        return stack(priors)

    def kl_loss(self, post: State, prior: State,
                free: float = 1.0) -> torch.Tensor:
        mp, sp = post["mean"].float(), post["std"].float()
        mq, sq = prior["mean"].float(), prior["std"].float()
        kl = (torch.log(sq / sp) + (sp ** 2 + (mp - mq) ** 2) / (2 * sq ** 2)
              - 0.5)
        return torch.clamp(global_mean(kl.sum(dim=(-3, -2, -1))), min=free)

    def sparsity_loss(self, post: State, prior_prob: float = 0.3,
                      free: float = 0.0, scale: float = 0.1,
                      forward: bool = True) -> torch.Tensor:
        """The Bernoulli KL between Ber(``prior_prob``) and the
        per-channel gate probabilities ``u_logit`` (KL(prior || post)
        where ``forward``), summed over channels, floored at ``free``,
        times ``scale``."""
        eps = 1e-6
        q = torch.clamp(post["u_logit"].float(), eps, 1.0 - eps)
        p = torch.clamp(torch.full_like(q, prior_prob), eps, 1.0 - eps)
        a, b = (p, q) if forward else (q, p)
        kl = a * torch.log(a / b) + (1.0 - a) * torch.log((1.0 - a)
                                                          / (1.0 - b))
        return torch.clamp(global_mean(kl.sum(dim=-1)), min=free) * scale


class SpatialWorldModel(nn.Module):
    def __init__(self, image_shape: Tuple[int, int, int] = (64, 64, 1),
                 stoch_ch: int = 16, deter_ch: int = 64, hidden_ch: int = 64,
                 embed_ch: int = 64, kl_scale: float = 1.0,
                 kl_free: float = 1.0, stochastic_gates: bool = True,
                 sparsity_scale: float = 0.1, gate_prior: float = 0.3,
                 gate_free: float = 0.0, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.image_shape, self.dtype = tuple(image_shape), dtype
        self.kl_scale, self.kl_free = kl_scale, kl_free
        self.stochastic_gates, self.sparsity_scale = (stochastic_gates,
                                                      sparsity_scale)
        self.gate_prior, self.gate_free = gate_prior, gate_free
        self.latent_hw = image_shape[0] // 4
        c = image_shape[-1]
        self.enc1 = Conv(c, embed_ch // 2, 4, stride=2, padding=1, **kw)
        self.enc2 = Conv(embed_ch // 2, embed_ch, 4, stride=2, padding=1,
                         **kw)
        self.dynamics = SpatialRSSM(
            embed_ch, stoch_ch=stoch_ch, deter_ch=deter_ch,
            hidden_ch=hidden_ch, latent_hw=self.latent_hw,
            stochastic_gates=stochastic_gates, **kw)
        self.dec1 = ConvTranspose(stoch_ch + deter_ch, embed_ch // 2, **kw)
        self.dec2 = ConvTranspose(embed_ch // 2, c, **kw)

    def _encode(self, image: torch.Tensor) -> torch.Tensor:
        b, t = image.shape[:2]
        x = image.reshape(b * t, *image.shape[2:]).to(self.dtype)
        x = F.relu(self.enc2(F.relu(self.enc1(x))))
        return x.reshape(b, t, *x.shape[1:])

    def _decode(self, feat: torch.Tensor) -> torch.Tensor:
        b, t = feat.shape[:2]
        x = self.dec2(F.relu(self.dec1(feat.reshape(b * t,
                                                    *feat.shape[2:]))))
        return x.reshape(b, t, *x.shape[1:])

    def loss(self, batch: Dict[str, torch.Tensor], generator=None,
             step: int = 0):
        if "image" not in batch:
            batch = {"image": torch.cat([batch["observed_data"],
                                         batch["data_to_predict"]], dim=1)}
        image = batch["image"].to(self.dtype)
        if tuple(image.shape[2:]) != self.image_shape:
            raise ValueError(
                f"SpatialDreamer built for image_shape={self.image_shape} "
                f"but the batch delivers {tuple(image.shape[2:])} — set "
                "--resolution/--in_channels to the dataset's actual frame "
                "geometry (MovingMNIST is fixed 64x64x1)")
        noise = as_noise(generator, "SpatialDreamer")
        post, prior, gate_mean = self.dynamics.observe(self._encode(image),
                                                       noise)
        kl = self.dynamics.kl_loss(post, prior, self.kl_free)
        mean = self._decode(self.dynamics.get_feat(post))
        recon = -torch.mean(image_log_prob(mean, image))
        if self.stochastic_gates:
            sparsity = self.dynamics.sparsity_loss(
                post, prior_prob=self.gate_prior, free=self.gate_free,
                scale=self.sparsity_scale)
        else:
            sparsity = torch.zeros((), device=image.device)
        total = recon + self.kl_scale * kl + sparsity
        metrics = {"loss": total, "image_loss": recon, "kl_loss": kl,
                   "gate_mean": gate_mean, "sparsity_loss": sparsity}
        return total, (metrics, mean.float())

    def predict(self, batch: Dict[str, torch.Tensor], generator=None):
        """The open-loop prediction of the frames to predict, in [0, 1]."""
        noise = as_noise(generator, "SpatialDreamer")
        n_in = batch["observed_data"].shape[1]
        n_out = batch["data_to_predict"].shape[1]
        post, _, _ = self.dynamics.observe(
            self._encode(batch["observed_data"]), noise)
        init = {k: v[:, n_in - 1] for k, v in post.items()}
        priors = self.dynamics.imagine(n_out, init, noise)
        return self._decode(self.dynamics.get_feat(priors)).float() + 0.5, {}
