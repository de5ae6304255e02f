"""The disentangled sequential VAE of the Sprites corpus (DS-VAE).

Counterpart of the training and predict path of
``ode_rl_tpu/sprite/dsvae.py::DisentangledVAE``:

* per-frame DCGAN features (sprite/nets.py), a forward and a backward
  LSTM over them (flax's OptimizedLSTMCell, nn/dense.py); the content
  latent f reads [forward at T-1, backward at 0]; the motion latents
  z_1..z_T come from a tanh RNN over the concatenated bi-LSTM outputs,
  with per-step mean and log-variance heads;
* a two-layer LSTM prior over z, teacher-forced on the posterior's
  sample;
* the motion-area (9-way) and eight-bin direction heads on z, computed
  as JAX computes them (the loss does not read them);
* the decode of concat(z_t, f) per frame;
* the loss: the summed squared reconstruction of the observed frames,
  KL(f || N(0, 1)) and KL(z || prior), each over B.

Every sample is mean + exp(logvar / 2) * eps, the eps drawn from the
caller's generator through ``Noise`` in JAX's order: f (B, f_dim), z
(B, T, z_dim), then the prior's (B, z_dim) at each of the T steps.

The probe forwards of the disentanglement evaluation (JAX's
``forward_exchange``, ``forward_fixed_content_for_classification``,
``forward_fixed_action_for_classification``, ``forward_fixed_motion``,
``forward_fixed_content`` and ``forward_generating``) take frames in
[0, 1], run in eval mode unless ``train`` says otherwise, and draw the
posterior's f and z, then their own draws: the free prior rollout's (B,
z_dim) at each step (its sample is the next step's input), or the
resampled content's (B, f_dim). ``forward_exchange`` swaps the content
of consecutive pairs, so an odd batch fails in the reshape, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ode_rl_torch.core.noise import Noise, as_noise
from ode_rl_torch.nn.conv_stacks import leaky_relu
from ode_rl_torch.nn.dense import LSTM, Dense, LSTMCell
from ode_rl_torch.sprite.nets import DCGANDecoder, DCGANEncoder


class DisentangledVAE(nn.Module):
    def __init__(self, f_dim: int = 256, z_dim: int = 32, g_dim: int = 128,
                 channels: int = 3, hidden_dim: int = 256, *, nf: int = 64,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(generator=generator)
        h = hidden_dim
        self.f_dim, self.z_dim, self.g_dim, self.hidden_dim = (f_dim, z_dim,
                                                               g_dim, h)
        self.dtype = dtype
        self.encoder = DCGANEncoder(channels, g_dim, nf, dtype=dtype, **kw)
        self.decoder = DCGANDecoder(z_dim + f_dim, channels, nf, dtype=dtype,
                                    **kw)
        self.lstm_fwd = LSTM(g_dim, h, **kw)
        self.lstm_bwd = LSTM(g_dim, h, reverse=True, **kw)
        self.f_mean = Dense(2 * h, f_dim, **kw)
        self.f_logvar = Dense(2 * h, f_dim, **kw)
        self.z_rnn_i = Dense(2 * h, h, **kw)
        self.z_rnn_h = Dense(h, h, **kw)
        self.z_mean = Dense(h, z_dim, **kw)
        self.z_logvar = Dense(h, z_dim, **kw)
        self.prior_ly1 = LSTMCell(z_dim, h, **kw)
        self.prior_ly2 = LSTMCell(h, h, **kw)
        self.z_prior_mean = Dense(h, z_dim, **kw)
        self.z_prior_logvar = Dense(h, z_dim, **kw)
        self.area_0 = Dense(z_dim, 2 * z_dim, **kw)
        self.area_1 = Dense(2 * z_dim, 9, **kw)
        for i in range(9):
            self.add_module(f"dir{i}_0", Dense(z_dim, 2 * z_dim, **kw))
            self.add_module(f"dir{i}_1", Dense(2 * z_dim, 8, **kw))

    @staticmethod
    def _reparam(mean: torch.Tensor, logvar: torch.Tensor,
                 noise: Noise) -> torch.Tensor:
        return mean + torch.exp(0.5 * logvar) * noise.normal(mean.shape, mean)

    def encode_and_sample_post(self, x: torch.Tensor, train: bool,
                               noise: Noise):
        b, t = x.shape[:2]
        conv_x = self.encoder(x.reshape(b * t, *x.shape[2:]), train).reshape(
            b, t, self.g_dim)
        fwd, bwd = self.lstm_fwd(conv_x), self.lstm_bwd(conv_x)
        lstm_out_f = torch.cat([fwd[:, -1], bwd[:, 0]], dim=-1)
        f_mean, f_logvar = self.f_mean(lstm_out_f), self.f_logvar(lstm_out_f)
        f_post = self._reparam(f_mean, f_logvar, noise)
        bi = torch.cat([fwd, bwd], dim=-1)
        hid = torch.zeros((b, self.hidden_dim), dtype=bi.dtype,
                          device=bi.device)
        feats = []
        for i in range(t):
            hid = torch.tanh(self.z_rnn_i(bi[:, i]) + self.z_rnn_h(hid))
            feats.append(hid)
        features = torch.stack(feats, dim=1)
        z_mean, z_logvar = self.z_mean(features), self.z_logvar(features)
        z_post = self._reparam(z_mean, z_logvar, noise)
        return f_mean, f_logvar, f_post, z_mean, z_logvar, z_post

    def _prior_rollout(self, frames: int, noise: Noise,
                       z_teacher: Optional[torch.Tensor] = None,
                       like: Optional[torch.Tensor] = None):
        """The two-layer LSTM prior, teacher-forced on ``z_teacher`` where
        it is given, else free-running on its own samples over the batch
        of ``like`` (B, ...)."""
        ref = like if z_teacher is None else z_teacher
        b = ref.shape[0]
        zeros = lambda: torch.zeros((b, self.hidden_dim), dtype=ref.dtype,
                                    device=ref.device)
        z_t = torch.zeros((b, self.z_dim), dtype=ref.dtype,
                          device=ref.device)
        c1, c2 = (zeros(), zeros()), (zeros(), zeros())
        means, logvars, zs = [], [], []
        for i in range(frames):
            c1, h1 = self.prior_ly1(c1, z_t)
            c2, h2 = self.prior_ly2(c2, h1)
            m, lv = self.z_prior_mean(h2), self.z_prior_logvar(h2)
            z_prior = self._reparam(m, lv, noise)
            means.append(m)
            logvars.append(lv)
            zs.append(z_prior)
            z_t = z_prior if z_teacher is None else z_teacher[:, i]
        stack = lambda v: torch.stack(v, dim=1)
        return stack(means), stack(logvars), stack(zs)

    def _decode(self, z_post: torch.Tensor, f_post: torch.Tensor,
                train: bool) -> torch.Tensor:
        b, t = z_post.shape[:2]
        f_expand = f_post[:, None].expand(b, t, self.f_dim)
        zf = torch.cat([z_post, f_expand], dim=-1)
        frames = self.decoder(zf.reshape(b * t, -1), train)
        return frames.reshape(b, t, *frames.shape[1:])

    def forward(self, x: torch.Tensor, generator=None,
                train: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """x (B, T, 64, 64, C) in [0, 1] -> the posterior's and the
        prior's stats and samples, the reconstruction and the motion
        heads' logits."""
        train = self.training if train is None else train
        noise = as_noise(generator, "DisentangledVAE")
        f_mean, f_logvar, f_post, z_mean, z_logvar, z_post = \
            self.encode_and_sample_post(x, train, noise)
        pm, plv, pz = self._prior_rollout(z_post.shape[1], noise, z_post)
        recon = self._decode(z_post, f_post, train)
        z_flat = z_post.reshape(-1, self.z_dim)
        lrelu = lambda v: leaky_relu(v, 0.2)
        pred_area = self.area_1(lrelu(self.area_0(z_flat)))
        pred_dirs = torch.cat([
            getattr(self, f"dir{i}_1")(lrelu(getattr(self, f"dir{i}_0")(
                z_flat))) for i in range(9)], dim=0)
        return {
            "f_mean": f_mean, "f_logvar": f_logvar, "f_post": f_post,
            "z_mean": z_mean, "z_logvar": z_logvar, "z_post": z_post,
            "z_mean_prior": pm, "z_logvar_prior": plv, "z_prior": pz,
            "recon": recon, "pred_area": pred_area, "pred_dirs": pred_dirs,
        }

    def loss(self, batch: Dict[str, torch.Tensor], generator=None,
             train: Optional[bool] = None):
        x = batch["observed_data"].to(self.dtype) + 0.5
        out = self(x, generator, train)
        b = x.shape[0]
        f32 = lambda k: out[k].float()
        recon = torch.sum(torch.square(f32("recon") - x.float())) / b
        f_lv, f_m = f32("f_logvar"), f32("f_mean")
        kl_f = -0.5 * torch.sum(1 + f_lv - f_m ** 2 - torch.exp(f_lv)) / b
        zm, zlv = f32("z_mean"), f32("z_logvar")
        pm, plv = f32("z_mean_prior"), f32("z_logvar_prior")
        kl_z = 0.5 * torch.sum(
            plv - zlv + (torch.exp(zlv) + (zm - pm) ** 2) / torch.exp(plv)
            - 1) / b
        loss = recon + kl_f + kl_z
        metrics = {"loss": loss, "recon_loss": recon, "kl_f": kl_f,
                   "kl_z": kl_z}
        return loss, (metrics, f32("recon"))

    def predict(self, batch: Dict[str, torch.Tensor], generator=None,
                train: Optional[bool] = None) -> Tuple[torch.Tensor, Dict]:
        x = batch["observed_data"].to(self.dtype) + 0.5
        return self(x, generator, train)["recon"].float(), {}

    # --------------------- probe forwards (evaluation) -----------------
    def _posterior(self, x: torch.Tensor, generator, train: bool):
        noise = as_noise(generator, "DisentangledVAE")
        return noise, self.encode_and_sample_post(x, train, noise)

    def forward_exchange(self, x: torch.Tensor, generator=None,
                         train: bool = False) -> torch.Tensor:
        """Each video decoded with its pair partner's content f (pairs
        (0, 1), (2, 3), ...)."""
        _, (_, _, f_post, _, _, z_post) = self._posterior(x, generator, train)
        perm = torch.arange(f_post.shape[0], device=f_post.device)
        perm = perm.reshape(-1, 2).flip(1).reshape(-1)
        return self._decode(z_post, f_post[perm], train)

    def forward_fixed_content_for_classification(
            self, x: torch.Tensor, generator=None, train: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The disagreement protocol's generator with the content pinned:
        (the decode of the free prior's per-step means with the posterior
        mean of f, the decode of the posterior means)."""
        noise, (f_mean, _, _, z_mean_post, _, _) = self._posterior(
            x, generator, train)
        z_mean_prior, _, _ = self._prior_rollout(x.shape[1], noise,
                                                 like=f_mean)
        return (self._decode(z_mean_prior, f_mean, train),
                self._decode(z_mean_post, f_mean, train))

    def forward_fixed_action_for_classification(
            self, x: torch.Tensor, generator=None, train: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The disagreement protocol's generator with the motion pinned:
        (the decode of the posterior means of z with f drawn from N(0, I),
        the decode of the posterior means)."""
        noise, (f_mean, _, _, z_mean_post, _, _) = self._posterior(
            x, generator, train)
        f_prior = noise.normal(f_mean.shape, f_mean)
        return (self._decode(z_mean_post, f_prior, train),
                self._decode(z_mean_post, f_mean, train))

    def forward_fixed_motion(self, x: torch.Tensor, generator=None,
                             train: bool = False) -> torch.Tensor:
        """The first video's z for all, each video's own f."""
        _, (_, _, f_post, _, _, z_post) = self._posterior(x, generator, train)
        return self._decode(z_post[:1].expand_as(z_post), f_post, train)

    def forward_fixed_content(self, x: torch.Tensor, generator=None,
                              train: bool = False) -> torch.Tensor:
        """The first video's f for all, each video's own z."""
        _, (_, _, f_post, _, _, z_post) = self._posterior(x, generator, train)
        return self._decode(z_post, f_post[:1].expand_as(f_post), train)

    def forward_generating(self, x: torch.Tensor, generator=None,
                           train: bool = False) -> torch.Tensor:
        """The posterior's f with z sampled from the free-running prior."""
        noise, (_, _, f_post, _, _, z_post) = self._posterior(
            x, generator, train)
        _, _, z_gen = self._prior_rollout(z_post.shape[1], noise,
                                          like=f_post)
        return self._decode(z_gen, f_post, train)
