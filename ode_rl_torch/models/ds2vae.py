"""DS2VAE, the disentangled slot-sequential VAE.

Counterpart of ``ode_rl_tpu/models/ds2vae.py``: a Conv3d stem; the
static path, a 'default' C3D encoder (nn/c3d.py) whose (B, T' h' w',
d_zf) set feeds slot attention, then per-slot Dense mu and log-variance
heads (std 0.5 exp(logvar), the family's); the dynamic path, a second
C3D encoder to ``n_hid`` channels averaged over space, padded with its
last step or trimmed to the prediction horizon, then a RIM (nn/rims.py;
dropout 0.5 in training) and Dense heads; a GRU prior over the dynamic
posterior's (mu, std) with a Dense head (softplus std + 1e-4); the
decode of concat(z_f slots, z_t) each frame with the 's2vae' slot
decoder; and the loss, the summed squared error plus KL(z_f || N(0, 1))
plus KL(z_t || prior), each over B T.

Draws, from the caller's generator through ``Noise``: the slots'
initial noise, the RIM's dropout masks (in training), then the z_f and
z_t samples.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.core.noise import as_noise
from ode_rl_torch.models.s2vae import gaussian_kl
from ode_rl_torch.nn.c3d import C3DEncoder, Conv3d, SlotCNNDecoder
from ode_rl_torch.nn.conv_stacks import leaky_relu
from ode_rl_torch.nn.dense import GRU, Dense
from ode_rl_torch.nn.rims import RIM
from ode_rl_torch.nn.slot_attention import SlotAttentionAutoEncoder


class DS2VAEModel(nn.Module):
    def __init__(self, in_channels: int = 1, d_zf: int = 128,
                 n_hid: int = 300, num_slots: int = 3, slot_size: int = 128,
                 num_iterations: int = 3, num_blocks: int = 3, topk: int = 3,
                 *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(generator=generator)
        ckw = dict(dtype=dtype, **kw)
        s, f = num_slots, slot_size
        self.in_channels, self.num_slots, self.slot_size = (in_channels, s,
                                                            f)
        self.dtype = dtype
        self.c3d_stem = Conv3d(in_channels, 32, (3, 3, 3), (1, 2, 2),
                               (1, 1, 1), **ckw)
        self.zf_net = C3DEncoder(32, d_zf, **ckw)
        self.slot_zf = SlotAttentionAutoEncoder(
            d_zf, num_slots=s, num_iterations=num_iterations, slot_size=f,
            **kw)
        self.slot_zf_mu_net = Dense(f, f, **kw)
        self.slot_zf_logvar_net = Dense(f, f, **kw)
        self.zt_net = C3DEncoder(32, n_hid, **ckw)
        self.dynamic_net = RIM(n_hid, [n_hid], [num_blocks], [topk], **kw)
        self.zt_mu_net = Dense(n_hid, f, **kw)
        self.zt_logvar_net = Dense(n_hid, f, **kw)
        self.prior_gru = GRU(2 * f, 2 * f, **kw)
        self.prior_head = Dense(2 * f, 2 * f, **kw)
        self.cnn_decoder = SlotCNNDecoder(s * f + f, in_channels, "s2vae",
                                          **ckw)

    def predict(self, batch: Dict[str, torch.Tensor], generator=None,
                train: Optional[bool] = None) -> Tuple[torch.Tensor, Dict]:
        train = self.training if train is None else train
        noise = as_noise(generator, "DS2VAE")
        inputs = batch["observed_data"].to(self.dtype) + 0.5
        b, _, h, w, _ = inputs.shape
        out_seq = batch["tp_to_predict"].shape[0]
        s, f = self.num_slots, self.slot_size
        x = leaky_relu(self.c3d_stem(inputs), 0.2)

        zf_enc = self.zf_net(x)
        slot_zf = self.slot_zf(zf_enc.reshape(b, -1, zf_enc.shape[-1]),
                               noise)                    # (B, S, f)
        zf_mu = self.slot_zf_mu_net(slot_zf)
        zf_std = 0.5 * torch.exp(self.slot_zf_logvar_net(slot_zf))

        z0_seq = self.zt_net(x).mean(dim=(2, 3))         # (B, T', n_hid)
        t_enc = z0_seq.shape[1]
        rim_in = (z0_seq[:, :out_seq] if t_enc >= out_seq else torch.cat(
            [z0_seq, z0_seq[:, -1:].expand(b, out_seq - t_enc, -1)], dim=1))
        zt_hidden, _ = self.dynamic_net(rim_in, train=train, noise=noise)
        zt_mu = self.zt_mu_net(zt_hidden)
        zt_std = 0.5 * torch.exp(self.zt_logvar_net(zt_hidden))

        outs, _ = self.prior_gru(torch.cat([zt_mu, zt_std], dim=-1))
        pri_mu, pri_raw = self.prior_head(outs).chunk(2, dim=-1)
        pri_std = F.softplus(pri_raw) + 1e-4

        zf = zf_mu + zf_std * noise.normal(zf_mu.shape, zf_mu)
        zt = zt_mu + zt_std * noise.normal(zt_mu.shape, zt_mu)
        zf_rep = zf.reshape(b, 1, s * f).expand(b, out_seq, s * f)
        dec_in = torch.cat([zf_rep, zt], dim=-1).reshape(b * out_seq, 1, 1,
                                                         -1)
        x_hat = self.cnn_decoder(dec_in, train).reshape(
            b, out_seq, h, w, self.in_channels)
        aux = {"zf_mu": zf_mu, "zf_std": zf_std, "zt_mu": zt_mu,
               "zt_std": zt_std, "prior_mu": pri_mu, "prior_std": pri_std}
        return x_hat.float(), aux

    def loss(self, batch: Dict[str, torch.Tensor], generator=None,
             train: Optional[bool] = None):
        x_hat, aux = self.predict(batch, generator, train)
        target = batch["data_to_predict"].float() + 0.5
        b, t = x_hat.shape[:2]
        a = {k: v.float() for k, v in aux.items()}
        recon = torch.sum(torch.square(x_hat - target)) / (b * t)
        zf_lv = 2 * torch.log(a["zf_std"])
        kl_zf = -0.5 * torch.sum(1 + zf_lv - a["zf_mu"] ** 2
                                 - torch.exp(zf_lv)) / (b * t)
        kl_zt = gaussian_kl(a["zt_mu"], a["zt_std"], a["prior_mu"],
                            a["prior_std"]) / (b * t)
        loss = recon + kl_zf + kl_zt
        metrics = {"loss": loss, "recon_loss": recon, "kl_zf": kl_zf,
                   "kl_zt": kl_zt}
        return loss, (metrics, x_hat)
