"""Adversarial training of Vid-ODE.

Counterpart of ``ode_rl_tpu/train/gan.py``: the generator (the Vid-ODE
model, with its BatchNorm buffers), an image and a sequence
``PatchDiscriminator`` (nn/discriminators.py), an Adamax optimizer for
each side (optax's betas and eps, as train/step.py makes it) and the
learning rate ``lr * lr_decay ** (step // steps_per_epoch)`` (optax's
staircase ``exponential_decay``; constant where ``lr_decay >= 1`` or the
epoch has no steps), read at the step count before the update, as
optax's schedule reads it.

A train step updates D on the generator's detached prediction, then G on
its loss plus ``lamb_adv`` times the LSGAN terms of the updated D. JAX
runs the generator forward twice, once under a stop-gradient for D's
update (whose BatchNorm statistics it drops) and once for G's (whose it
keeps); both start from the same parameters, statistics, batch and noise
and compute the same prediction. The port runs it once, with autograd,
and gives D its detached output: the statistics that survive the step
are that forward's, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from ode_rl_torch.core.noise import global_rows
from ode_rl_torch.models.registry import build_model, cfg_get
from ode_rl_torch.nn.discriminators import (PatchDiscriminator,
                                            frames_to_images, lsgan_d_loss,
                                            lsgan_g_loss,
                                            rearrange_seq_extrap,
                                            rearrange_seq_interp,
                                            seq_channels)
from ode_rl_torch.parallel.mesh import Mesh, entered


def make_gan_lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int],
                                                                float]:
    lr = float(cfg.lr)
    decay = float(cfg_get(cfg, "lr_decay", 0.99))
    if decay >= 1.0 or steps_per_epoch <= 0:
        return lambda step: lr
    return lambda step: lr * decay ** (step // steps_per_epoch)


def _adamax(params, lr: float) -> torch.optim.Optimizer:
    return torch.optim.Adamax(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


class GANState:
    """Generator, discriminators (``disc["image"]``, ``disc["seq"]``),
    their optimizers, the schedule and the step count."""

    def __init__(self, gen: nn.Module, disc: nn.ModuleDict,
                 schedule: Callable[[int], float]):
        self.gen, self.disc, self.schedule = gen, disc, schedule
        self.gen_opt = _adamax(gen.parameters(), schedule(0))
        self.disc_opt = _adamax(disc.parameters(), schedule(0))
        self.step = 0

    def snapshot(self) -> Dict:
        """The checkpoint's fields, as JAX names them."""
        return {"gen_params": {n: p.detach() for n, p in
                               self.gen.named_parameters()},
                "gen_model_state": {n: b for n, b in
                                    self.gen.named_buffers()},
                "disc_params": self.disc.state_dict()}


def create_gan_state(cfg, device: torch.device, sample_batch: Dict,
                     steps_per_epoch: int = 0,
                     extrap: bool = True) -> GANState:
    """The generator ``cfg.model`` names and the two discriminators, each
    initialised from a CPU generator seeded with ``cfg.seed``; the
    sequence discriminator sized for ``sample_batch``'s windows."""
    generator = torch.Generator().manual_seed(int(cfg.seed))
    gen = build_model(cfg, device, generator)
    _, t, _, _, c = sample_batch["data_to_predict"].shape
    t_ctx = sample_batch["observed_data"].shape[1]
    disc = nn.ModuleDict({
        "image": PatchDiscriminator(c, generator=generator),
        "seq": PatchDiscriminator(seq_channels(t_ctx, t, c, extrap),
                                  generator=generator),
    }).to(device)
    return GANState(gen, disc, make_gan_lr_schedule(cfg, steps_per_epoch))


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def make_gan_train_step(extrap: bool = True, lamb_adv: float = 0.003,
                        mesh: Optional[Mesh] = None) -> Callable[..., Dict]:
    """(state, batch, generator=None) -> metrics: the D update, then the
    G update. The metrics: the generator's loss terms, ``g_adv_loss``,
    ``recon_total``, ``d_loss``, ``g_loss`` and ``lr``. Under a ``mesh``
    ``batch`` holds this rank's rows, the generator runs inside the mesh,
    D's and G's gradients are each averaged over the ranks before their
    update, and the metrics are the global batch's."""
    rearrange = rearrange_seq_extrap if extrap else rearrange_seq_interp

    def train_step(state: GANState, batch: Dict,
                   generator: Optional[torch.Generator] = None) -> Dict:
        if mesh is not None:
            generator = global_rows(generator, mesh.rank, mesh.world)
        with entered(mesh):
            metrics = _step(state, batch, generator)
        return metrics if mesh is None else mesh.mean_metrics(metrics)

    def _step(state: GANState, batch: Dict, generator) -> Dict:
        gen, disc = state.gen, state.disc
        real = batch["data_to_predict"].float() + 0.5
        context = batch["observed_data"].float() + 0.5
        lr = state.schedule(state.step)
        gen.train()
        gen.zero_grad(set_to_none=True)
        recon_loss, (metrics, fake) = gen.loss(batch, generator)

        # D on the detached prediction.
        fake_d = fake.detach()
        disc.zero_grad(set_to_none=True)
        d_img, d_seq = disc["image"], disc["seq"]
        d_loss = (lsgan_d_loss(d_img(frames_to_images(real)),
                               d_img(frames_to_images(fake_d)))
                  + lsgan_d_loss(d_seq(rearrange(real, context)),
                                 d_seq(rearrange(fake_d, context))))
        d_loss.backward()
        if mesh is not None:
            mesh.all_reduce_grads(disc.parameters())
        _set_lr(state.disc_opt, lr)
        state.disc_opt.step()

        # G against the updated D, which takes no gradient here.
        disc.requires_grad_(False)
        try:
            adv = (lsgan_g_loss(d_img(frames_to_images(fake)))
                   + lsgan_g_loss(d_seq(rearrange(fake, context))))
        finally:
            disc.requires_grad_(True)
        g_loss = recon_loss + lamb_adv * adv
        g_loss.backward()
        if mesh is not None:
            mesh.all_reduce_grads(gen.parameters())
        _set_lr(state.gen_opt, lr)
        state.gen_opt.step()
        state.step += 1

        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        metrics.update(g_adv_loss=adv.detach(),
                       recon_total=recon_loss.detach(),
                       d_loss=d_loss.detach(), g_loss=g_loss.detach(),
                       lr=lr)
        return metrics

    return train_step
