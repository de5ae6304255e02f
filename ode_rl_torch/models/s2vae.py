"""S2VAE and CS2VAE, the slot-sequential VAEs.

Counterpart of ``ode_rl_tpu/models/s2vae.py``: a Conv3d stem (32
channels, space halved) and the C3D encoder (nn/c3d.py: 'default' for
S2VAE, 'cgru' for CS2VAE); slot attention over the encoder's
(B, T' h' w', d_zf) set gives each slot its z0; each slot rolls out to
the prediction horizon with parameters of its own (JAX maps one module
over the slots with ``nn.vmap``; here ``slot_rollout`` is a list of S
modules, and convert.py splits JAX's stacked leaves among them):

* 'gru' (S2VAE): a stack of ``gru_layers`` flax GRU cells (nn/dense.py)
  free-running on zero inputs from z0, each layer feeding the next, then
  Dense ``mu`` and ``logvar`` heads;
* 'cgru' (CS2VAE): a 4x4 VALID transposed conv ``up`` of z0 (1x1 ->
  4x4), a ConvGRU (``trans``, nn/convgru.py: hidden ``slot_size``, so
  kernels K3/K4 at (B, 4, 4, 2 slot_size) in 2 slot_size/32 groups and
  (B, 4, 4, slot_size) in slot_size/32, once a slot a step) free-running
  ``out_seq`` steps, then 3x3 conv heads.

The posterior std is the family's ``0.5 * exp(logvar)``. The prior is
N(0, 1) ('standard') or ('infer') a GRU over the posterior's (mu, std)
sequence of each slot with a Dense head, softplus std + 1e-4. The sample
is one draw of the posterior's shape. The decoder (nn/c3d.py) takes each
frame's slots concatenated ((B T, 1, 1, S f), or (B T, 4, 4, S f) for
CS2VAE); with ``unmasked=False`` it decodes each slot with an alpha
channel, and the frame is the softmax-over-slots composite. The loss is
``s2vae_vae_loss``: the summed squared error and the closed-form KL,
each over B T.

Draws, from the caller's generator through ``Noise``: the slots' initial
noise (B, S, slot_size), then the posterior sample.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.core.noise import as_noise
from ode_rl_torch.nn.c3d import C3DEncoder, Conv3d, SlotCNNDecoder
from ode_rl_torch.nn.conv_stacks import Conv, leaky_relu
from ode_rl_torch.nn.convgru import ConvGRUCell, convgru_freerun
from ode_rl_torch.nn.dense import GRU, Dense, GRUCell
from ode_rl_torch.nn.s3vae_nets import ConvTransposeStride1
from ode_rl_torch.nn.slot_attention import SlotAttentionAutoEncoder


def gaussian_kl(post_mu, post_std, pri_mu, pri_std) -> torch.Tensor:
    """The summed closed-form KL(post || prior) through log-variances."""
    pri_lv, post_lv = 2 * torch.log(pri_std), 2 * torch.log(post_std)
    return 0.5 * torch.sum(
        pri_lv - post_lv
        + (torch.exp(post_lv) + (post_mu - pri_mu) ** 2) / torch.exp(pri_lv)
        - 1)


def s2vae_vae_loss(x_hat, target, post_mu, post_std, prior_mu, prior_std):
    """(recon, kl): the summed squared error and KL(post || prior), each
    over B T."""
    b, t = x_hat.shape[:2]
    recon = torch.sum(torch.square(x_hat - target)) / (b * t)
    return recon, gaussian_kl(post_mu, post_std, prior_mu,
                              prior_std) / (b * t)


class _GRUStack(nn.Module):
    """Layers ``l0``, ``l1``, ... of flax GRU cells, width f."""

    def __init__(self, f: int, layers: int, *, generator: torch.Generator):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"l{i}", GRUCell(f, f, generator=generator))

    def freerun(self, z0: torch.Tensor, out_seq: int) -> torch.Tensor:
        """Every layer from z0; the first on zero inputs (its input
        projection is the bias), each next on the one below. (B, f) ->
        the last layer's hiddens (B, out_seq, f)."""
        cells = [getattr(self, f"l{i}") for i in range(self.layers)]
        iw = [c.input_weights() for c in cells]
        hw = [c.hidden_weights() for c in cells]
        hs, outs = [z0] * self.layers, []
        for _ in range(out_seq):
            for i, cell in enumerate(cells):
                xp = (iw[0][1].expand(z0.shape[0], -1) if i == 0
                      else hs[i - 1] @ iw[i][0] + iw[i][1])
                hs[i] = cell.step(hs[i], xp, *hw[i])
            outs.append(hs[-1])
        return torch.stack(outs, dim=1)


class _SlotGRURollout(nn.Module):
    """One slot of S2VAE: the GRU stack free-run, Dense heads."""

    def __init__(self, f: int, gru_layers: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.trans = _GRUStack(f, gru_layers, generator=generator)
        self.mu = Dense(f, f, generator=generator)
        self.logvar = Dense(f, f, generator=generator)

    def forward(self, z0: torch.Tensor, out_seq: int):
        roll = self.trans.freerun(z0, out_seq)          # (B, T, f)
        return self.mu(roll), self.logvar(roll)


class _SlotCGRURollout(nn.Module):
    """One slot of CS2VAE: ``up`` to 4x4, the ConvGRU free-run (kernels
    K3/K4 at every step), 3x3 conv heads."""

    def __init__(self, f: int, *, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.f = f
        self.up = ConvTransposeStride1(f, f, **kw)
        self.trans = ConvGRUCell(f, f, **kw)
        self.mu = Conv(f, f, 3, padding=1, **kw)
        self.logvar = Conv(f, f, 3, padding=1, **kw)

    def forward(self, z0: torch.Tensor, out_seq: int):
        b = z0.shape[0]
        up = self.up(z0.reshape(b, 1, 1, self.f))        # (B, 4, 4, f)
        roll, _ = convgru_freerun(self.trans, up, out_seq)
        flat = roll.reshape(b * out_seq, *roll.shape[2:])
        heads = [h(flat).reshape(roll.shape) for h in (self.mu, self.logvar)]
        return heads[0], heads[1]


class S2VAEModel(nn.Module):
    def __init__(self, in_channels: int = 1, d_zf: int = 128,
                 num_slots: int = 3, slot_size: int = 128,
                 num_iterations: int = 3, gru_layers: int = 2,
                 transition: str = "gru", conv_mode: bool = False,
                 prior: str = "standard", unmasked: bool = True, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        if transition not in ("gru", "cgru"):
            raise NotImplementedError(f"transition {transition!r}")
        if prior not in ("standard", "infer"):
            raise NotImplementedError(f"prior {prior!r}")
        kw = dict(generator=generator)
        ckw = dict(dtype=dtype, **kw)
        s, f = num_slots, slot_size
        self.in_channels, self.num_slots, self.slot_size = (in_channels, s,
                                                            f)
        self.transition, self.prior, self.unmasked = (transition, prior,
                                                      unmasked)
        self.dtype = dtype
        self.c3d_stem = Conv3d(in_channels, 32, (3, 3, 3), (1, 2, 2),
                               (1, 1, 1), **ckw)
        self.z_net = C3DEncoder(32, d_zf, "cgru" if transition == "cgru"
                                else "default", **ckw)
        self.slot_z = SlotAttentionAutoEncoder(
            d_zf, num_slots=s, num_iterations=num_iterations, slot_size=f,
            **kw)
        self.slot_rollout = nn.ModuleList([
            _SlotGRURollout(f, gru_layers, **kw) if transition == "gru"
            else _SlotCGRURollout(f, **ckw) for _ in range(s)])
        if prior == "infer":
            # The GRU reads each slot's flattened (mu, std) per step.
            d = 2 * f * (1 if transition == "gru" else 16)
            self.prior_gru = GRU(d, 2 * f, **kw)
            self.prior_head = Dense(2 * f, d, **kw)
        self.cnn_decoder = SlotCNNDecoder(
            s * f if unmasked else f, in_channels,
            "cs2vae" if conv_mode else "s2vae", unmasked, **ckw)

    def predict(self, batch: Dict[str, torch.Tensor], generator=None,
                train: Optional[bool] = None) -> Tuple[torch.Tensor, Dict]:
        train = self.training if train is None else train
        noise = as_noise(generator, "S2VAE")
        inputs = batch["observed_data"].to(self.dtype) + 0.5
        b, _, h, w, c = inputs.shape
        out_seq = batch["tp_to_predict"].shape[0]
        s, f = self.num_slots, self.slot_size

        z_enc = self.z_net(leaky_relu(self.c3d_stem(inputs), 0.2))
        slot_z0 = self.slot_z(z_enc.reshape(b, -1, z_enc.shape[-1]), noise)
        heads = [roll(slot_z0[:, i], out_seq)
                 for i, roll in enumerate(self.slot_rollout)]
        post_mu = torch.stack([m for m, _ in heads], dim=1)  # (B, S, T, ...)
        post_std = 0.5 * torch.exp(torch.stack([lv for _, lv in heads],
                                               dim=1))
        if self.prior == "infer":
            seq = torch.cat([post_mu, post_std], dim=-1).reshape(
                b * s, out_seq, -1)
            pri = self.prior_head(self.prior_gru(seq)[0])
            pri_mu, pri_raw = pri.chunk(2, dim=-1)
            prior_mu = pri_mu.reshape(post_mu.shape)
            prior_std = F.softplus(pri_raw).reshape(post_std.shape) + 1e-4
        else:
            prior_mu = torch.zeros_like(post_mu)
            prior_std = torch.ones_like(post_std)
        zs = post_mu + post_std * noise.normal(post_mu.shape, post_mu)

        if self.unmasked:
            dec_base = zs.transpose(1, 2)                # (B, T, S, ...)
            if self.transition == "cgru":
                dec_base = dec_base.movedim(2, -2)       # (B, T, 4, 4, S, f)
            dec_base = dec_base.reshape(b * out_seq, *(
                (1, 1) if self.transition == "gru" else zs.shape[3:5]), s * f)
            x_hat = self.cnn_decoder(dec_base, train).reshape(
                b, out_seq, h, w, self.in_channels)
        else:
            per_slot = zs.reshape(b * s * out_seq, *(
                (1, 1, f) if self.transition == "gru" else zs.shape[3:]))
            out = self.cnn_decoder(per_slot, train).reshape(
                b, s, out_seq, h, w, self.in_channels + 1)
            masks = torch.softmax(out[..., -1:], dim=1)
            x_hat = torch.sum(out[..., :-1] * masks, dim=1)
        aux = {"post_mu": post_mu, "post_std": post_std,
               "prior_mu": prior_mu, "prior_std": prior_std}
        return x_hat.float(), aux

    def loss(self, batch: Dict[str, torch.Tensor], generator=None,
             train: Optional[bool] = None):
        x_hat, aux = self.predict(batch, generator, train)
        target = batch["data_to_predict"].float() + 0.5
        recon, kl = s2vae_vae_loss(
            x_hat, target, *(aux[k].float() for k in (
                "post_mu", "post_std", "prior_mu", "prior_std")))
        loss = recon + kl
        metrics = {"loss": loss, "vae_loss": loss, "recon_loss": recon,
                   "kl_loss": kl}
        return loss, (metrics, x_hat)
