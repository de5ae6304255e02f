"""Optical-flow training on the synthetic-chairs stream.

Counterpart of ``ode_rl_tpu/flow/train.py``: the 'digits' supervision
generator (two frames of three moving digits, each pixel labelled with the
motion of the digit in front of it), the train step with the multiscale
loss or FlowNet2's single-scale L1/L2 and the EPE metric, Adam with
optax's betas and eps, the fused step that makes its batch on the device,
and a short training run.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ode_rl_torch.data.mmnist import generate_moving_mnist_per_digit
from ode_rl_torch.data.sprites import get_sprite_bank
from ode_rl_torch.flow.losses import epe, multiscale_loss
from ode_rl_torch.ops.resize import resize_bilinear
from ode_rl_torch.train.step import TrainState, global_norm


def flow_batch_from_digits(per_digit: torch.Tensor, pos: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(img1, img2, flow) from per-digit canvases (B, D, 2, H, W) in
    [0, 255] and positions (B, D, 2, 2) (y, x): the max-composite of each
    frame repeated to 3 channels, and on frame 1 the (dx, dy) motion of the
    digit in front of each pixel, 0 on the background."""
    comp = per_digit.amax(dim=1) / 255.0                   # (B, 2, H, W)
    img1 = comp[:, 0, :, :, None].expand(-1, -1, -1, 3).contiguous()
    img2 = comp[:, 1, :, :, None].expand(-1, -1, -1, 3).contiguous()
    inten1 = per_digit[:, :, 0]                            # (B, D, H, W)
    front = F.one_hot(inten1.argmax(dim=1), per_digit.shape[1]).float()
    occupied = (inten1.amax(dim=1) > 0.0)[..., None]
    delta = (pos[:, :, 1] - pos[:, :, 0]).float()          # (B, D, [dy, dx])
    dsel = torch.einsum("bhwd,bdc->bhwc", front, delta)
    flow = torch.where(occupied, dsel.flip(-1), torch.zeros_like(dsel))
    return img1, img2, flow


def synthetic_flow_batch(generator: torch.Generator,
                         sprite_bank: torch.Tensor, batch: int = 8,
                         style: str = "digits"
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(img1, img2, flow) supervision triplets with exact ground truth,
    64x64, made on the sprite bank's device from ``generator``."""
    if style != "digits":
        raise NotImplementedError(f"style {style!r} is not ported; only "
                                  "'digits'")
    per, _idx, pos = generate_moving_mnist_per_digit(
        generator, sprite_bank, batch=batch, n_frames=2, num_digits=3)
    return flow_batch_from_digits(per, pos)


def flow_loss_and_grads(model: torch.nn.Module,
                        inputs: Sequence[torch.Tensor],
                        target_flow: torch.Tensor, loss_norm: str = "l1",
                        single_scale: bool = False) -> Dict:
    """Loss and EPE, with the gradients left in ``.grad``. Pyramid nets
    train with the multiscale loss and report the EPE of the finest flow
    upsampled x4; ``single_scale`` (FlowNet2) takes the mean L1 or squared
    error of the one full-resolution flow."""
    model.zero_grad(set_to_none=True)
    out = model(*inputs)
    if single_scale:
        d = out - target_flow
        loss = d.abs().mean() if loss_norm == "l1" else (d * d).mean()
        err = epe(out.detach(), target_flow)
    else:
        loss = multiscale_loss(out, target_flow, norm=loss_norm)
        b, h, w, _ = target_flow.shape
        err = epe(resize_bilinear(out[0].detach(), h, w) * 4.0, target_flow)
    loss.backward()
    return {"loss": loss.detach(), "epe": err}


def make_flow_train_step(model: torch.nn.Module, lr: float = 1e-4,
                         loss_norm: str = "l1", single_scale: bool = False
                         ) -> Tuple[Callable, Callable]:
    """(init_fn, step_fn): ``init_fn()`` gives the model's TrainState with
    Adam at ``lr`` (optax's betas and eps); ``step_fn(state, inputs,
    target_flow)`` takes one step and returns {"loss", "epe",
    "grad_norm"}."""

    def init_fn() -> TrainState:
        return TrainState(model, torch.optim.Adam(
            model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8))

    def step_fn(state: TrainState, inputs: Sequence[torch.Tensor],
                target_flow: torch.Tensor) -> Dict:
        metrics = flow_loss_and_grads(state.model, inputs, target_flow,
                                      loss_norm, single_scale)
        metrics["grad_norm"] = global_norm(
            p.grad for p in state.model.parameters() if p.grad is not None)
        state.optimizer.step()
        state.step += 1
        return metrics

    return init_fn, step_fn


def make_fused_flow_train_step(model: torch.nn.Module,
                               sprite_bank: torch.Tensor, batch: int,
                               lr: float = 1e-4, loss_norm: str = "l1",
                               single_scale: bool = False
                               ) -> Tuple[Callable, Callable]:
    """(init_fn, step_fn) where ``step_fn(state, generator)`` makes a
    synthetic-chairs batch on the device and trains on it. The JAX version
    double-buffers the batch inside one XLA program so that its scheduler
    can overlap datagen with the network step; eager PyTorch has no such
    scheduler, so this step generates its batch first and then trains on
    that same batch."""
    init_fn, base_step = make_flow_train_step(model, lr, loss_norm,
                                              single_scale)

    def step_fn(state: TrainState, generator: torch.Generator) -> Dict:
        img1, img2, flow = synthetic_flow_batch(generator, sprite_bank,
                                                batch=batch)
        return base_step(state, (img1, img2), flow)

    return init_fn, step_fn


def train_flownet(model: torch.nn.Module, steps: int = 100, batch: int = 8,
                  lr: float = 1e-4, seed: int = 0, pair_input: bool = True,
                  single_scale: bool = False) -> Dict:
    """A training run on the synthetic stream, on the model's device;
    returns the last step's metrics as floats and the state.
    ``pair_input=False`` for the two-image nets (FlowNetC, FlowNet2)."""
    device = next(model.parameters()).device
    bank = torch.from_numpy(get_sprite_bank()).float().to(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    init_fn, step_fn = make_flow_train_step(model, lr,
                                            single_scale=single_scale)
    state = init_fn()
    metrics = {}
    for _ in range(steps):
        img1, img2, flow = synthetic_flow_batch(generator, bank, batch=batch)
        inputs = ((torch.cat([img1, img2], dim=-1),) if pair_input
                  else (img1, img2))
        metrics = step_fn(state, inputs, flow)
    out = {k: float(v) for k, v in metrics.items()}
    out["state"] = state
    return out
