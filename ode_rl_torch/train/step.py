"""Train and eval steps.

Counterpart of ``ode_rl_tpu/train/step.py``: Adam or Adamax
(``torch.optim.Adam``/``Adamax`` with optax's betas and eps; Adamax keeps
nu = max(b2 * nu, |g| + eps) and corrects only mu, as ``optax.adamax``),
global-norm clipping where ``clip`` is not -1 (``optax.clip_by_global_norm``,
not ``clip_grad_norm_``: the gradients stay as they are where the norm is
below ``clip``, and are otherwise g / norm * clip, with no epsilon), the
``grad_norm`` metric (global L2 norm of the raw gradients, before
clipping, as ``optax.global_norm``), the NaN guard with its
``nan_skipped`` metric (core/debug.py), ``debug_nans`` (core/debug.py:
``FloatingPointError`` at a step whose forward or backward makes a NaN),
the lr of ``lr_scheduler: plateau`` (``cfg.lr`` times the scale that
train/schedulers.py sets in the param groups), the train step on a given batch,
the fused step that makes its own Moving MNIST batch on the device, and
the eval step (prediction without autograd, per-horizon MSE, PSNR and
SSIM, and the model's stats as ``aux_*``). The train step runs the model
in training mode (BatchNorm on the batch's moments, moving its running
ones; dropout on) and the eval step in eval mode. A model that predicts
the whole sequence (S3VAE in eval: t_in + n_out frames) is held to the
observed frames followed by ``data_to_predict``. S3VAE's batches carry
the motion-grid labels of its DFP loss (from FlowNetC's flow where the
fused step is given its label function).

Each step takes an optional ``torch.Generator`` that a model drawing
noise (ODEConv with ``z_sample``, S3VAE) draws it from, as JAX's steps
take a key for the 'sample' rng.

With a ``mesh`` (parallel/) the steps compute, on each rank, its share
of the unsharded step on the global batch: the model's cross-row terms
and draws global, the gradients averaged over the ranks before
``grad_norm``, the clip and the NaN guard, and the metrics the global
batch's. On a ``('data', 'model')`` mesh a parameter may hold a
``'model'`` slice (parallel/tp.py): its squares enter ``grad_norm``
summed over the ``'model'`` line, a replicated one's once, and the NaN
guard skips on every rank where any rank's gradient is not finite. On a
``('data', 'space')`` mesh every batch tensor holds this rank's rows of
the frame height too (parallel/sp.py); the models whose every layer
knows the cut (``supports_space``) take it.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ode_rl_torch.core.checkpoint import CheckpointManager, find_checkpoint
from ode_rl_torch.core.config import Config
from ode_rl_torch.core.debug import (check_finite, nan_checks,
                                     nan_guard_update)
from ode_rl_torch.core.noise import global_rows
from ode_rl_torch.data.mmnist import IMAGE_SIZE, generate_moving_mnist
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.models.registry import build_model, cfg_get
from ode_rl_torch.parallel.mesh import MODEL_AXIS, SPACE_AXIS, Mesh, entered
from ode_rl_torch.parallel.sp import shard_video
from ode_rl_torch.train.metrics import per_frame_metrics


def needs_flow_labels(cfg) -> bool:
    """Whether the model's loss reads the motion-grid labels (S3VAE)."""
    return cfg.model == "S3VAE"


class TrainState:
    """Model, optimizer, gradient clip (-1: none) and step count of one
    training run."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, clip: float = -1.0):
        self.model = model
        self.optimizer = optimizer
        self.clip = clip
        self.step = 0


_OPTIMIZERS = {"adam": torch.optim.Adam, "adamax": torch.optim.Adamax}


def make_optimizer(cfg, params) -> torch.optim.Optimizer:
    name = cfg_get(cfg, "optimizer", "adam")
    if name not in _OPTIMIZERS:
        raise NotImplementedError(f"optimizer {name!r}")
    return _OPTIMIZERS[name](params, lr=float(cfg.lr), betas=(0.9, 0.999),
                             eps=1e-8)


def create_train_state(cfg, device: torch.device) -> TrainState:
    """The model ``cfg.model`` names, initialised from ``cfg.seed`` (on
    the CPU, so the weights do not depend on the device), moved to
    ``device``, with its optimizer."""
    generator = torch.Generator().manual_seed(int(cfg.seed))
    model = build_model(cfg, device, generator)
    return TrainState(model, make_optimizer(cfg, model.parameters()),
                      clip=float(cfg_get(cfg, "clip", -1)))


def restore_model(logdir, model_name: str, ckpt_id: str,
                  device: torch.device, step: Optional[int] = None
                  ) -> Tuple[torch.nn.Module, Config, int]:
    """The model of a run of ``python -m ode_rl_torch.main`` (tag
    ``ckpt_id`` under ``<logdir>/<model_name>``): built from the config
    saved beside its checkpoints, its parameters and buffers (BatchNorm's
    running statistics) from the newest snapshot or ``step``. Returns
    (model, config, step)."""
    ckpt = CheckpointManager(find_checkpoint(logdir, model_name, ckpt_id),
                             tag=ckpt_id)
    saved = ckpt.load_config()
    if saved is None:
        raise FileNotFoundError(f"no saved config beside the checkpoints "
                                f"in {ckpt.directory}")
    cfg = Config(saved)
    model = build_model(cfg, device, torch.Generator().manual_seed(
        int(cfg.get("seed", 0))))
    restored = ckpt.restore({"model": model.state_dict()}, step=step)
    model.load_state_dict(restored["state"]["model"])
    return model, cfg, restored["step"]


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def grad_norm(params, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The global norm of the ``.grad`` of ``params``: a parameter that
    holds a ``'model'`` slice (``tp_dim``) adds its squares summed over
    the ``'model'`` line, a replicated one its own once."""
    params = [p for p in params if p.grad is not None]
    if mesh is None or mesh.size(MODEL_AXIS) == 1:
        return global_norm(p.grad for p in params)
    squares = lambda ps: sum((torch.sum(torch.square(p.grad.float()))
                              for p in ps), torch.zeros(
                                  (), device=params[0].grad.device))
    sharded = squares(p for p in params
                      if getattr(p, "tp_dim", None) is not None)
    mesh.all_reduce_(sharded, MODEL_AXIS)
    return torch.sqrt(squares(p for p in params
                              if getattr(p, "tp_dim", None) is None)
                      + sharded)


def clip_by_global_norm(grads: List[torch.Tensor], norm: torch.Tensor,
                        max_norm: float) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm`` given the global ``norm``: each
    gradient kept where norm < max_norm, else (g / norm) * max_norm."""
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def loss_and_grads(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   debug_nans: bool = False, mesh: Optional[Mesh] = None):
    """Loss metrics and prediction, with gradients left in ``.grad``;
    with ``debug_nans``, ``FloatingPointError`` where the forward or the
    backward makes a NaN. With a ``mesh``, ``batch`` holds this rank's
    rows: the model runs inside the mesh (its terms that mix rows global,
    its draws the rank's rows of the global ones), then the gradients
    are averaged over the ranks and the metrics are the global batch's."""
    model.zero_grad(set_to_none=True)
    if mesh is not None:
        if mesh.size(SPACE_AXIS) > 1 and not getattr(
                model, "supports_space", False):
            raise NotImplementedError(
                f"{type(model).__name__} under a 'space' axis: only the "
                "models whose every layer knows the cut take height-sharded "
                "frames (ODEConvGRUModel, ConvGRUModel)")
        generator = global_rows(generator, mesh.index("data"),
                                mesh.size("data"))
    with nan_checks(debug_nans), entered(mesh):
        loss, (metrics, pred) = model.loss(batch, generator)
        if debug_nans:
            check_finite("forward", {"loss": loss, **metrics,
                                     "prediction": pred})
        loss.backward()
    metrics = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
    if mesh is not None:
        mesh.all_reduce_grads(model.parameters())
        metrics = mesh.mean_metrics(metrics)
    metrics["grad_norm"] = grad_norm(model.parameters(), mesh)
    return metrics, pred.detach()


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               nan_guard: bool = False, debug_nans: bool = False,
               mesh: Optional[Mesh] = None) -> Dict:
    """One step: gradients (averaged over the ``mesh``'s ranks),
    ``grad_norm`` of the raw ones, the clip, the optimizer's update and,
    with ``nan_guard``, the parameters put back where a raw gradient is
    not finite (``nan_skipped`` 1); every rank takes the same decision."""
    state.model.train()
    metrics, _ = loss_and_grads(state.model, batch, generator, debug_nans,
                                mesh)
    params = [p for p in state.model.parameters() if p.grad is not None]
    grads = [p.grad for p in params]
    if state.clip != -1:
        clipped = clip_by_global_norm(grads, metrics["grad_norm"], state.clip)
        for p, g in zip(params, clipped):
            p.grad = g
    old = [p.detach().clone() for p in params] if nan_guard else None
    state.optimizer.step()
    if nan_guard:
        metrics["nan_skipped"] = nan_guard_update(params, old, grads, mesh)
    state.step += 1
    return metrics


def make_train_step(nan_guard: bool = False, debug_nans: bool = False,
                    mesh: Optional[Mesh] = None) -> Callable[..., Dict]:
    """(state, batch, generator=None) -> metrics: one step on a given
    batch (this rank's rows of it under a ``mesh``)."""
    return functools.partial(train_step, nan_guard=nan_guard,
                             debug_nans=debug_nans, mesh=mesh)


def make_eval_step() -> Callable[..., Tuple[Dict, torch.Tensor]]:
    """(model, batch, generator=None) -> (metrics, pred): per-horizon
    ``mse``, ``psnr`` and ``ssim`` (each (T,)) and the model's stats as
    ``aux_<name>``."""

    @torch.no_grad()
    def eval_step(model: torch.nn.Module, batch: Dict,
                  generator: Optional[torch.Generator] = None):
        was_training = model.training
        model.eval()
        try:
            pred, aux = model.predict(batch, generator)
        finally:
            model.train(was_training)
        target = batch["data_to_predict"].float() + 0.5
        if pred.shape[1] != target.shape[1]:
            target = torch.cat([batch["observed_data"].float() + 0.5,
                                target], dim=1)
        metrics = per_frame_metrics(pred, target)
        metrics.update({f"aux_{k}": v for k, v in aux.items()
                        if not k.startswith("_")})
        return metrics, pred

    return eval_step


def make_fused_train_step(cfg, sprite_bank: torch.Tensor,
                          flow_label_fn: Optional[Callable] = None,
                          mesh: Optional[Mesh] = None
                          ) -> Callable[..., Dict]:
    """(state, generator, sample_generator=None) -> metrics: a Moving
    MNIST batch made on the device from ``generator`` (S3VAE's labels
    from ``flow_label_fn`` where it is given), then one training step
    (with ``cfg.nan_guard`` and ``cfg.debug_nans``) that draws any model
    noise from ``sample_generator``. Under a ``mesh`` every rank makes the
    global batch from the same generator and trains on its rows, as JAX
    shards the generated batch at its source (rows of the height too
    under ``'space'``)."""
    if cfg.resolution != IMAGE_SIZE:
        raise NotImplementedError(f"the generator makes {IMAGE_SIZE}x"
                                  f"{IMAGE_SIZE} frames")
    n_in = int(cfg.train_in_seq)
    n_frames = n_in + int(cfg.train_out_seq)
    with_flow = needs_flow_labels(cfg)
    step = make_train_step(bool(cfg_get(cfg, "nan_guard", False)),
                           bool(cfg_get(cfg, "debug_nans", False)), mesh)

    def fused_step(state: TrainState, generator: torch.Generator,
                   sample_generator: Optional[torch.Generator] = None
                   ) -> Dict:
        video = generate_moving_mnist(generator, sprite_bank,
                                      batch=int(cfg.batch_size),
                                      n_frames=n_frames,
                                      num_digits=int(cfg.num_digits))
        if mesh is not None:
            video = (shard_video(video, mesh) if mesh.size(SPACE_AXIS) > 1
                     else video[mesh.rows(video.shape[0])])
        return step(state, make_batch_dict(video, n_in=n_in,
                                           with_flow_labels=with_flow,
                                           flow_label_fn=flow_label_fn),
                    sample_generator)

    return fused_step
