"""S3VAE, the disentangled sequential VAE.

Counterpart of ``ode_rl_tpu/models/s3vae.py``: a static latent z_f and
dynamic latents z_1..z_T with a learned prior, trained with
``l0 * VAE + l1 * SCC + l2 * DFP + l3 * MI``:

* VAE: the summed squared reconstruction error, KL(z_f || N(0, 1)) and
  KL(q(z_t) || prior), each over B * T;
* SCC: a triplet margin loss between z_f of the video (the anchor), of
  its time-shuffled frames (positive) and of another video of the batch
  (negative); the positive and negative are drawn without gradient;
* DFP: the BCE of the motion-grid logits against the batch's labels;
* MI: the minibatch-weighted logsumexp estimate of I(z_f; z_t).

Encoders: 'default' (vectors: the 64x64 -> 1x1 frame CNN and GRU heads,
optionally a RIM dynamic head and slot attention on z_f), 'cgru' (maps,
ConvGRU heads), 'cgru_sa' (as 'cgru' at 1/8 of the frame, optionally
slot attention on z_f's maps), 'cgru_rim' (conv-RIM heads) and 'odecgru'
(the ODE-ConvGRU z0 and a Neural-ODE rollout as the dynamic head).

As in JAX: the three static passes (anchor, positive, negative) run as
one pass of 3B rows; the negative's features are ``feats[perm_b]`` (the
frame encoder is frame-wise and its BatchNorm moments are those of the
same multiset of frames); the heads' softplus std goes through the
reference's exp(0.5 * x); with ``train`` the model predicts t_in frames
and otherwise t_in + n_out, and BatchNorm and dropout follow ``train``,
which defaults to the module's mode (``model.train()``/``eval()``).

Every random draw comes from the caller's generator, through one
``Noise`` (core/noise.py), in JAX's order: ``perm_t``, ``perm_b``, one
(3B, S, D) slot-init draw for each slot module, the z_f and z_t
epsilons; then in the loss the SCC anchor, positive and negative, and
MI's z_t and z_f samples.

Inside a data-parallel mesh (parallel/mesh.py) a rank holds rows of the
global batch: ``perm_b`` permutes the global batch and the negatives'
features are all-gathered, MI's logsumexp runs over the stats of every
row, log(N * M) takes the global M, and the draws are the rank's rows of
the global ones (the static pass's of each of its three blocks).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.core.noise import Noise, as_noise
from ode_rl_torch.nn.s3vae_nets import (DFP, ConvGRUEncoderS3, FrameDecoder,
                                        FrameEncoder, GRUEncoder)
from ode_rl_torch.nn.slot_attention import SlotAttentionAutoEncoder
from ode_rl_torch.parallel.mesh import active, gather_rows, world


def _normal_logprob(mu, std, x):
    var = std * std
    return -0.5 * (torch.log(2.0 * math.pi * var) + (x - mu) ** 2 / var)


def scc_triplet_loss(anchor, pos, neg, margin: float) -> torch.Tensor:
    """``torch.nn.TripletMarginLoss`` as the reference calls it on these
    tensors: the L2 distance along torch's last axis only, with the 1e-6
    added to the difference, the hinge, the mean over the rest. The last
    axis of an NCHW map is W, which is axis -2 of NHWC; so inputs of rank
    4 or more reduce axis -2, others axis -1."""
    axis = -2 if anchor.ndim >= 4 else -1
    dist = lambda a, b: torch.sqrt(torch.sum(torch.square(a - b + 1e-6),
                                             dim=axis))
    return torch.mean(F.relu(dist(anchor, pos) - dist(anchor, neg) + margin))


def dfp_bce_loss(logits, labels) -> torch.Tensor:
    """BCE of sigmoid(logits) against the labels, with 1e-7 in the logs."""
    p = torch.sigmoid(logits)
    return -torch.mean(labels * torch.log(p + 1e-7)
                       + (1 - labels) * torch.log(1 - p + 1e-7))


def mi_estimate(mu_t, std_t, zt_s, mu_f, std_f, zf_s,
                log_nm) -> torch.Tensor:
    """The minibatch-weighted estimate of I(z_f; z_t) from time-first
    dynamic stats (T, B, ...), static stats (B, ...), the samples to
    evaluate, and log_nm = log(N * M)."""
    log_q_t = _normal_logprob(mu_t[:, None], std_t[:, None], zt_s[:, :, None])
    log_q_t = log_q_t.sum(dim=tuple(range(3, log_q_t.ndim)))     # (T, B, B)
    log_q_f = _normal_logprob(mu_f[None], std_f[None], zf_s[:, None])
    log_q_f = log_q_f.sum(dim=tuple(range(2, log_q_f.ndim)))     # (B, B)
    log_q_f = log_q_f[None].expand_as(log_q_t)
    h_t = -torch.logsumexp(log_q_t - log_nm, dim=2)              # (T, B)
    h_f = -torch.logsumexp(log_q_f - log_nm, dim=2)
    h_ft = -torch.logsumexp(log_q_t + log_q_f - log_nm, dim=2)
    return torch.mean(F.relu(-h_ft + h_f + h_t))


class S3VAEModel(nn.Module):
    def __init__(self, in_channels: int = 1, d_zf: int = 256, d_zt: int = 32,
                 encoder: str = "default", n_hid: int = 512,
                 encoder_out_dims: int = 128, k_stat: int = -1,
                 l0: float = 10.0, l1: float = 1000.0, l2: float = 100.0,
                 l3: float = 1.0, margin: float = 1.0, slot_att: bool = False,
                 num_slots: int = 3, slot_size: int = 128,
                 num_iterations: int = 3, rim: bool = False,
                 unit_per_rim: int = 100, rim_num_blocks: int = 4,
                 rim_topk: int = 3, flow_grid: int = 3,
                 extrapolate: bool = False, data_points: int = 10000,
                 train_test_split: float = 0.8, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.in_channels, self.encoder, self.k_stat = (in_channels, encoder,
                                                       k_stat)
        self.l0, self.l1, self.l2, self.l3 = l0, l1, l2, l3
        self.margin, self.extrapolate = margin, extrapolate
        self.data_points, self.train_test_split = (data_points,
                                                   train_test_split)
        self.dtype = dtype
        self.vec = vec = encoder == "default"
        num_rims = n_hid // unit_per_rim if rim else 1
        kw = dict(generator=generator)
        ckw = dict(dtype=dtype, **kw)
        feat = encoder_out_dims
        self.conv_encoder = FrameEncoder(in_channels, encoder, feat, **ckw)
        if vec:
            self.static_rnn = GRUEncoder(feat, n_hid, d_zf, "static", **kw)
            self.dynamic_rnn = GRUEncoder(feat, n_hid, d_zt, "dynamic",
                                          rim=rim, num_rims=num_rims, **kw)
            zt_dim = d_zt * num_rims
            self.prior_rnn = GRUEncoder(2 * zt_dim, n_hid, zt_dim, "prior",
                                        **kw)
        else:
            rim_kw = dict(rim_num_blocks=rim_num_blocks, rim_topk=rim_topk)
            self.static_rnn = ConvGRUEncoderS3(feat, d_zf, "static", encoder,
                                               **rim_kw, **ckw)
            self.dynamic_rnn = ConvGRUEncoderS3(feat, d_zt, "dynamic",
                                                encoder, **rim_kw, **ckw)
            self.prior_rnn = ConvGRUEncoderS3(2 * d_zt, d_zt, "prior", "cgru",
                                              **ckw)
            zt_dim = d_zt
        self.use_slots = slot_att and encoder in ("default", "cgru_sa")
        zf_dim = d_zf
        if self.use_slots:
            sa = lambda: SlotAttentionAutoEncoder(
                d_zf, num_slots=num_slots,
                num_iterations=num_iterations, slot_size=slot_size,
                conv_input=not vec, **kw)
            self.mu_slot_att = sa()
            self.logvar_slot_att = sa()
            zf_dim = num_slots * slot_size
        self.conv_decoder = FrameDecoder(zf_dim + zt_dim, encoder,
                                         in_channels, **ckw)
        self.dfp_net = DFP(zt_dim, d_zt, flow_grid ** 2, spatial=not vec,
                           **ckw)

    def _static(self, feats: torch.Tensor, t_in: int, train: bool,
                noise: Noise):
        t_use = t_in if self.k_stat == -1 else min(self.k_stat, t_in)
        mu, lv = self.static_rnn(feats[:, :t_use], train=train, noise=noise)
        if self.use_slots:
            n = feats.shape[0]
            mu = self.mu_slot_att(mu, noise).reshape(n, -1)
            lv = self.logvar_slot_att(lv, noise).reshape(n, -1)
        return mu, lv

    def _decode(self, zf: torch.Tensor, zt: torch.Tensor, shape: tuple,
                train: bool) -> torch.Tensor:
        b, out_seq, h, w = shape
        if self.vec:
            zf_rep = zf[:, None, :].expand(b, out_seq, zf.shape[-1])
            dec_in = torch.cat([zf_rep, zt], dim=-1).reshape(
                b * out_seq, 1, 1, -1)
        else:
            if self.use_slots:
                # Slot vectors broadcast back over the latent grid.
                zf = zf[:, None, None, :].expand(b, zt.shape[2], zt.shape[3],
                                                 zf.shape[-1])
            zf_rep = zf[:, None].expand(b, out_seq, *zf.shape[1:])
            dec_in = torch.cat([zf_rep, zt], dim=-1).reshape(
                b * out_seq, *zt.shape[2:4], -1)
        x = torch.sigmoid(self.conv_decoder(dec_in, train))
        return x.reshape(b, out_seq, h, w, self.in_channels)

    def predict(self, batch: Dict[str, torch.Tensor], generator=None,
                train: Optional[bool] = None, swap: bool = False
                ) -> Tuple[torch.Tensor, Dict]:
        train = self.training if train is None else train
        noise = as_noise(generator, "S3VAE")
        inputs = batch["observed_data"].to(self.dtype) + 0.5
        b, t_in, h, w, c = inputs.shape
        out_seq = t_in if train else t_in + batch["tp_to_predict"].shape[0]

        feats = self.conv_encoder(inputs.reshape(b * t_in, h, w, c), train)
        feats = feats.reshape(b, t_in, -1) if self.vec else feats.reshape(
            b, t_in, *feats.shape[1:])
        perm_t = noise.permutation(t_in, feats.device)
        # The negative is another video of the global batch, under a
        # data-parallel mesh perhaps another rank's (parallel/mesh.py).
        mesh = active()
        n_ranks = 1 if mesh is None else mesh.world
        perm_b = noise.permutation(b * n_ranks, feats.device)
        if mesh is None:
            neg = feats[perm_b]
        else:
            neg = gather_rows(feats)[perm_b[mesh.rows(b * n_ranks)]]

        # Anchor, time-shuffled positive and the other video's negative as
        # one pass of 3B rows.
        mu3, lv3 = self._static(torch.cat([feats, feats[:, perm_t], neg]),
                                t_in, train, noise.in_blocks(3))
        mu_zf, pos_mu, neg_mu = mu3.chunk(3)
        lv_zf, pos_lv, neg_lv = lv3.chunk(3)
        to_std = lambda lv: torch.exp(0.5 * lv)
        std_zf = to_std(lv_zf)

        kw = dict(out_seq=out_seq, train=train, noise=noise)
        if not self.vec:
            kw["timesteps"] = batch.get("observed_tp")
        mu_zt, lv_zt = self.dynamic_rnn(feats, **kw)
        std_zt = to_std(lv_zt)
        prior_mu, prior_lv = self.prior_rnn(
            torch.cat([mu_zt, std_zt], dim=-1), train=train, noise=noise)

        zf = mu_zf + std_zf * noise.normal(mu_zf.shape, mu_zf)
        zt = mu_zt + std_zt * noise.normal(mu_zt.shape, mu_zt)
        shape = (b, out_seq, h, w)
        x_hat = self._decode(zf, zt, shape, train)
        aux = {
            "dfp_logits": self.dfp_net(zt).float(),
            "mu_zf": mu_zf, "std_zf": std_zf, "zf": zf,
            "pos_mu": pos_mu, "pos_std": to_std(pos_lv),
            "neg_mu": neg_mu, "neg_std": to_std(neg_lv),
            "mu_zt": mu_zt, "std_zt": std_zt, "zt": zt,
            "prior_mu": prior_mu, "prior_std": to_std(prior_lv),
        }
        if swap:
            # Each video's z_f with the batch's next video's z_t, and the
            # converse.
            aux["x_swap_motion"] = self._decode(
                zf, torch.roll(zt, 1, 0), shape, train).float()
            aux["x_swap_content"] = self._decode(
                torch.roll(zf, 1, 0), zt, shape, train).float()
        return x_hat.float(), aux

    def loss(self, batch: Dict[str, torch.Tensor], generator=None,
             train: Optional[bool] = None):
        noise = as_noise(generator, "S3VAE")
        x_hat, aux = self.predict(batch, noise, train)
        inputs = batch["observed_data"].float() + 0.5
        b, t = x_hat.shape[:2]
        target = (batch["data_to_predict"].float() + 0.5 if self.extrapolate
                  else inputs)
        if target.shape[1] != t:
            # A test block's long horizon: the common prefix.
            t = min(target.shape[1], t)
            target, x_hat = target[:, :t], x_hat[:, :t]

        # 1. The VAE terms.
        recon = torch.sum(torch.square(x_hat - target)) / (b * t)
        mu_zf, std_zf = aux["mu_zf"].float(), aux["std_zf"].float()
        logvar_zf = 2.0 * torch.log(std_zf)
        kl_zf = -0.5 * torch.sum(
            1 + logvar_zf - mu_zf ** 2 - torch.exp(logvar_zf)) / (b * t)
        post_mu, post_std = aux["mu_zt"].float(), aux["std_zt"].float()
        pri_mu, pri_std = aux["prior_mu"].float(), aux["prior_std"].float()
        pri_lv, post_lv = 2 * torch.log(pri_std), 2 * torch.log(post_std)
        kl_zt = 0.5 * torch.sum(
            pri_lv - post_lv
            + (torch.exp(post_lv) + (post_mu - pri_mu) ** 2)
            / torch.exp(pri_lv) - 1) / (b * t)
        vae_loss = recon + kl_zf + kl_zt

        # 2. SCC: the positive and negative drawn without gradient.
        anchor = mu_zf + std_zf * noise.normal(mu_zf.shape, mu_zf)
        with torch.no_grad():
            pos = (aux["pos_mu"] + aux["pos_std"] * noise.normal(
                aux["pos_mu"].shape, aux["pos_mu"])).float()
            neg = (aux["neg_mu"] + aux["neg_std"] * noise.normal(
                aux["neg_mu"].shape, aux["neg_mu"])).float()
        scc_loss = scc_triplet_loss(anchor, pos, neg, self.margin)

        # 3. DFP over the T - 1 transitions.
        labels = (batch["out_flow_labels"] if self.extrapolate
                  else batch["in_flow_labels"]).float()
        logits = aux["dfp_logits"]
        n_lab = min(labels.shape[1], logits.shape[1])
        dfp_loss = dfp_bce_loss(logits[:, :n_lab], labels[:, :n_lab])

        # 4. MI.
        mi_loss = self._mi_loss(aux, b, noise)

        loss = (self.l0 * vae_loss + self.l1 * scc_loss
                + self.l2 * dfp_loss + self.l3 * mi_loss)
        metrics = {
            "loss": loss, "vae_loss": vae_loss, "recon_loss": recon,
            "kl_zf": kl_zf, "kl_zt": kl_zt, "scc_loss": scc_loss,
            "dfp_loss": dfp_loss, "mi_loss": mi_loss,
        }
        return loss, (metrics, x_hat)

    def _mi_loss(self, aux: Dict, b: int, noise: Noise) -> torch.Tensor:
        n = self.data_points * self.train_test_split
        mu_t = aux["mu_zt"].float().movedim(1, 0)
        std_t = aux["std_zt"].float().movedim(1, 0)
        zt_s = mu_t + std_t * noise.normal_at(mu_t.shape, mu_t, batch_axis=1)
        mu_f, std_f = aux["mu_zf"].float(), aux["std_zf"].float()
        zf_s = mu_f + std_f * noise.normal(mu_f.shape, mu_f)
        # The rank's samples against the stats of every row of the global
        # batch (parallel/mesh.py).
        # log(N * M) taken in fp32, as jnp.log takes it.
        log_nm = torch.log(torch.tensor(n * b * world(),
                                        dtype=torch.float32,
                                        device=mu_t.device))
        return mi_estimate(gather_rows(mu_t, dim=1),
                           gather_rows(std_t, dim=1), zt_s,
                           gather_rows(mu_f), gather_rows(std_f), zf_s,
                           log_nm)
