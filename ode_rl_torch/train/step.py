"""Train and eval steps.

Counterpart of ``ode_rl_tpu/train/step.py``: Adam (``torch.optim.Adam``
with optax.adam's betas and eps), the ``grad_norm`` metric (global L2
norm of the gradients, as ``optax.global_norm``), the train step on a
given batch, the fused step that makes its own Moving MNIST batch on the
device, and the eval step (prediction without autograd, per-horizon MSE,
PSNR and SSIM, and the model's stats as ``aux_*``). Gradient clipping,
``nan_guard`` and optimizers other than Adam are not ported yet (ROADMAP
queue 1, item 3, 9d); a config asking for them raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ode_rl_torch.data.mmnist import IMAGE_SIZE, generate_moving_mnist
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.models.registry import build_model, cfg_get
from ode_rl_torch.train.metrics import per_frame_metrics


class TrainState:
    """Model, optimizer and step count of one training run."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer):
        self.model = model
        self.optimizer = optimizer
        self.step = 0


def make_optimizer(cfg, params) -> torch.optim.Optimizer:
    if float(cfg_get(cfg, "clip", -1)) != -1:
        raise NotImplementedError("gradient clipping is not ported: "
                                  "ROADMAP queue 1, item 3 (9d)")
    name = cfg_get(cfg, "optimizer", "adam")
    if name != "adam":
        raise NotImplementedError(f"optimizer {name!r} is not ported: "
                                  "ROADMAP queue 1, item 3 (9d)")
    return torch.optim.Adam(params, lr=float(cfg.lr), betas=(0.9, 0.999),
                            eps=1e-8)


def create_train_state(cfg, device: torch.device) -> TrainState:
    """The model ``cfg.model`` names, initialised from ``cfg.seed`` (on
    the CPU, so the weights do not depend on the device), moved to
    ``device``, with its optimizer."""
    generator = torch.Generator().manual_seed(int(cfg.seed))
    model = build_model(cfg, device, generator)
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


def make_train_step(nan_guard: bool = False
                    ) -> Callable[[TrainState, Dict], Dict]:
    """(state, batch) -> metrics: one step on a given batch."""
    if nan_guard:
        raise NotImplementedError("nan_guard is not ported: ROADMAP queue "
                                  "1, item 3 (9d)")
    return train_step


def make_eval_step() -> Callable[[torch.nn.Module, Dict],
                                 Tuple[Dict, torch.Tensor]]:
    """(model, batch) -> (metrics, pred): per-horizon ``mse``, ``psnr``
    and ``ssim`` (each (T,)) and the model's stats as ``aux_<name>``."""

    @torch.no_grad()
    def eval_step(model: torch.nn.Module, batch: Dict):
        pred, aux = model.predict(batch)
        target = batch["data_to_predict"].float() + 0.5
        metrics = per_frame_metrics(pred, target)
        metrics.update({f"aux_{k}": v for k, v in aux.items()
                        if not k.startswith("_")})
        return metrics, pred

    return eval_step


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
