"""Train step: generate, batch, loss, backward, Adam update.

Counterpart of ``ode_rl_tpu/train/step.py`` on the flagship path: Adam
(``torch.optim.Adam`` with optax.adam's betas and eps), the ``grad_norm``
metric (global L2 norm of the gradients, as ``optax.global_norm``), and
the fused step that makes its own Moving MNIST batch on the device.
Gradient clipping and the solvers other than dopri5 'fast' are not ported
yet; a config asking for them raises.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ode_rl_torch.data.mmnist import IMAGE_SIZE, generate_moving_mnist
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.models.odeconvgru import ODEConvGRUModel

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TrainState:
    """Model, optimizer and step count of one training run."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer):
        self.model = model
        self.optimizer = optimizer
        self.step = 0


def make_optimizer(cfg, params) -> torch.optim.Optimizer:
    if float(cfg.clip) != -1:
        raise NotImplementedError("gradient clipping is not ported")
    return torch.optim.Adam(params, lr=float(cfg.lr), betas=(0.9, 0.999),
                            eps=1e-8)


def create_train_state(cfg, device: torch.device) -> TrainState:
    """Model initialised from ``cfg.seed`` (on the CPU, so the weights do
    not depend on the device), moved to ``device``, with its optimizer."""
    if (cfg.decode_diff_method, cfg.ode_solver) != ("dopri5", "fast"):
        raise NotImplementedError("only the dopri5 'fast' solver is ported")
    generator = torch.Generator().manual_seed(cfg.seed)
    model = ODEConvGRUModel(
        in_channels=cfg.in_channels, n_downs=cfg.n_downs,
        conv_encoder_out_ch=cfg.conv_encoder_out_ch,
        neural_ode_decoder_out_ch=cfg.neural_ode_decoder_out_ch,
        neural_ode_n_units=cfg.neural_ode_n_units,
        n_ode_layers=cfg.n_ode_layers, rtol=float(cfg.odeint_rtol),
        atol=float(cfg.odeint_atol), ode_max_steps=int(cfg.ode_max_steps),
        dtype=_DTYPES[cfg.compute_dtype], generator=generator).to(device)
    return TrainState(model, make_optimizer(cfg, model.parameters()))


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def loss_and_grads(model: torch.nn.Module, batch: Dict[str, torch.Tensor]):
    """Loss metrics and prediction, with gradients left in ``.grad``."""
    model.zero_grad(set_to_none=True)
    loss, (metrics, pred) = model.loss(batch)
    loss.backward()
    metrics = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
    metrics["grad_norm"] = global_norm(
        p.grad for p in model.parameters() if p.grad is not None)
    return metrics, pred.detach()


def train_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict:
    metrics, _ = loss_and_grads(state.model, batch)
    state.optimizer.step()
    state.step += 1
    return metrics


def make_fused_train_step(cfg, sprite_bank: torch.Tensor
                          ) -> Callable[[TrainState, torch.Generator], Dict]:
    """(state, generator) -> metrics: a Moving MNIST batch made on the
    device from ``generator``, then one training step."""
    if cfg.resolution != IMAGE_SIZE:
        raise NotImplementedError(f"the generator makes {IMAGE_SIZE}x"
                                  f"{IMAGE_SIZE} frames")
    n_in = int(cfg.train_in_seq)
    n_frames = n_in + int(cfg.train_out_seq)

    def fused_step(state: TrainState, generator: torch.Generator) -> Dict:
        video = generate_moving_mnist(generator, sprite_bank,
                                      batch=int(cfg.batch_size),
                                      n_frames=n_frames,
                                      num_digits=int(cfg.num_digits))
        return train_step(state, make_batch_dict(video, n_in=n_in))

    return fused_step
