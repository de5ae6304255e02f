"""Optical-flow training on the synthetic-chairs stream or a disk corpus.

Counterpart of ``ode_rl_tpu/flow/train.py``: the two supervision
generators ('digits': two frames of three moving digits, each pixel
labelled with the motion of the digit in front of it; 'smooth': one
frame warped backwards by a bicubic upsample of 4x4 noise), the train
step with the multiscale loss or FlowNet2's single-scale L1/L2 and the
EPE metric, Adam with optax's betas and eps, the fused step that makes its
batch on the device, a training run on the synthetic stream or a
FlyingChairs-layout corpus with its held-out EPE, and the flow nets'
weights in JAX's file format (flax msgpack of the flax tree, so either
package reads the other's) with the staged FlowNet2 warm start
(``graft_params``).
"""

from __future__ import annotations

import pathlib
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ode_rl_torch.convert import flax_to_torch, torch_to_flax
from ode_rl_torch.core import msgpack
from ode_rl_torch.data.mmnist import (generate_moving_mnist,
                                      generate_moving_mnist_per_digit)
from ode_rl_torch.data.sprites import get_sprite_bank
from ode_rl_torch.flow.data import FlyingChairsCorpus, validate_epe
from ode_rl_torch.flow.losses import epe, multiscale_loss
from ode_rl_torch.ops.resize import resize_bicubic, resize_bilinear
from ode_rl_torch.ops.warp import resample2d
from ode_rl_torch.parallel.mesh import Mesh
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


def smooth_flow_from(img1: torch.Tensor, coarse: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(img1, img2, flow) of the 'smooth' style from a (B, H, W, 3) frame
    and (B, h, w, 2) coarse noise: the noise resized bicubically to H x W
    is the flow, and img2 is img1 warped backwards by it (``resample2d``:
    img2(p) = img1(p + flow(p)))."""
    b, h, w, _ = img1.shape
    flow = resize_bicubic(coarse, h, w)
    return img1, resample2d(img1, flow), flow


def synthetic_flow_batch(generator: torch.Generator,
                         sprite_bank: torch.Tensor, batch: int = 8,
                         style: str = "digits"
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(img1, img2, flow) supervision triplets with exact ground truth,
    64x64, made on the sprite bank's device from ``generator``. 'smooth':
    one Moving MNIST frame of three digits in [0, 1], repeated to 3
    channels, and 4x4 normal noise times 3 as the coarse flow."""
    if style == "smooth":
        video = generate_moving_mnist(generator, sprite_bank, batch=batch,
                                      n_frames=1, num_digits=3) + 0.5
        img1 = video[:, 0].expand(-1, -1, -1, 3).contiguous()
        coarse = torch.randn((batch, 4, 4, 2), generator=generator,
                             device=sprite_bank.device) * 3.0
        return smooth_flow_from(img1, coarse)
    if style != "digits":
        raise ValueError(f"unknown style {style!r}: 'digits' or 'smooth'")
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
                         loss_norm: str = "l1", single_scale: bool = False,
                         mesh: Optional[Mesh] = None
                         ) -> Tuple[Callable, Callable]:
    """(init_fn, step_fn): ``init_fn()`` gives the model's TrainState with
    Adam at ``lr`` (optax's betas and eps); ``step_fn(state, inputs,
    target_flow)`` takes one step and returns {"loss", "epe",
    "grad_norm"}. Under a ``mesh`` the inputs are this rank's rows, the
    gradients are averaged over the ranks before ``grad_norm`` and the
    update, and the metrics are the global batch's."""

    def init_fn() -> TrainState:
        return TrainState(model, torch.optim.Adam(
            model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8))

    def step_fn(state: TrainState, inputs: Sequence[torch.Tensor],
                target_flow: torch.Tensor) -> Dict:
        metrics = flow_loss_and_grads(state.model, inputs, target_flow,
                                      loss_norm, single_scale)
        if mesh is not None:
            mesh.all_reduce_grads(state.model.parameters())
            metrics = mesh.mean_metrics(metrics)
        metrics["grad_norm"] = global_norm(
            p.grad for p in state.model.parameters() if p.grad is not None)
        state.optimizer.step()
        state.step += 1
        return metrics

    return init_fn, step_fn


def make_fused_flow_train_step(model: torch.nn.Module,
                               sprite_bank: torch.Tensor, batch: int,
                               lr: float = 1e-4, loss_norm: str = "l1",
                               single_scale: bool = False,
                               mesh: Optional[Mesh] = None
                               ) -> Tuple[Callable, Callable]:
    """(init_fn, step_fn) where ``step_fn(state, generator)`` makes a
    synthetic-chairs batch on the device and trains on it. The JAX version
    double-buffers the batch inside one XLA program so that its scheduler
    can overlap datagen with the network step; eager PyTorch has no such
    scheduler, so this step generates its batch first and then trains on
    that same batch. Under a ``mesh`` every rank makes the global batch
    of ``batch`` pairs and trains on its rows."""
    init_fn, base_step = make_flow_train_step(model, lr, loss_norm,
                                              single_scale, mesh)

    def step_fn(state: TrainState, generator: torch.Generator) -> Dict:
        img1, img2, flow = synthetic_flow_batch(generator, sprite_bank,
                                                batch=batch)
        if mesh is not None:
            rows = mesh.rows(batch)
            img1, img2, flow = img1[rows], img2[rows], flow[rows]
        return base_step(state, (img1, img2), flow)

    return init_fn, step_fn


def train_flownet(model: torch.nn.Module, steps: int = 100, batch: int = 8,
                  lr: float = 1e-4, seed: int = 0, pair_input: bool = True,
                  single_scale: bool = False, data_root=None,
                  validate: bool = False,
                  init_params: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> Dict:
    """A training run on the model's device; returns the last step's
    metrics as floats and the state. ``pair_input=False`` for the
    two-image nets (FlowNetC, FlowNet2).

    Batches come from the synthetic 'digits' stream, or with ``data_root``
    from a FlyingChairs-layout corpus (its train split, drawn with
    ``seed``); a batch is drawn before the first step and dropped, as JAX
    draws its init sample, so both take the same corpus batches.
    ``validate`` adds ``val_epe``, the EPE over the corpus's held-out
    split. ``init_params`` (a ``state_dict``, e.g. from ``graft_params``)
    is loaded before the optimizer starts."""
    device = next(model.parameters()).device
    if data_root is not None:
        corpus = FlyingChairsCorpus(data_root, batch_size=batch,
                                    is_train=True, seed=seed)

        def draw():
            return tuple(torch.from_numpy(a).to(device)
                         for a in next(corpus))
    else:
        bank = torch.from_numpy(get_sprite_bank()).float().to(device)
        generator = torch.Generator(device=device).manual_seed(seed)

        def draw():
            return synthetic_flow_batch(generator, bank, batch=batch)

    draw()
    if init_params is not None:
        model.load_state_dict(init_params)
    init_fn, step_fn = make_flow_train_step(model, lr,
                                            single_scale=single_scale)
    state = init_fn()
    metrics = {}
    for _ in range(steps):
        img1, img2, flow = draw()
        inputs = ((torch.cat([img1, img2], dim=-1),) if pair_input
                  else (img1, img2))
        metrics = step_fn(state, inputs, flow)
    out = {k: float(v) for k, v in metrics.items()}
    if validate and data_root is not None:
        val = FlyingChairsCorpus(data_root, batch_size=batch,
                                 is_train=False, seed=seed)
        out["val_epe"] = validate_epe(model, val, pair_input=pair_input,
                                      single_scale=single_scale)
    out["state"] = state
    return out


def save_flownet_params(model: torch.nn.Module, path) -> None:
    """Write the model's weights as JAX's ``save_flownet_params`` does:
    the flax msgpack of ``{"params": <flax tree>}``, which JAX's loop and
    the port's read as ``flownet_params_path``."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tree = torch_to_flax(model.state_dict(), model)
    p.write_bytes(msgpack.dumps({"params": tree}))


def load_flownet_params(path) -> Dict:
    """The tree a weights file holds (``{"params": ...}``, numpy
    leaves), as JAX's ``load_flownet_params`` reads it."""
    return msgpack.loads(pathlib.Path(path).read_bytes())


def load_flax_params(module: torch.nn.Module, tree: Mapping) -> None:
    """Load a flax 'params' tree (numpy leaves) into ``module``,
    strictly."""
    module.load_state_dict(flax_to_torch(tree, module=module), strict=True)


def graft_params(dst: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                 src: Mapping, module: Optional[torch.nn.Module] = None
                 ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Copy the leaves of the flax tree ``src`` into ``dst`` (a module, or
    a ``state_dict`` with its ``module``) wherever the flax path exists in
    both and the flax-layout shapes agree; every other entry keeps its
    ``dst`` value. This is the staged FlowNet2 warm start: each sub-net
    starts from its separately trained checkpoint, and a leaf whose shape
    differs (the stacked FlowNetS's 12-channel ``conv1`` against the
    standalone's 6) is skipped.

    Returns ``(state_dict, n_grafted, n_skipped)``, counted as JAX's
    ``graft_params`` counts over the flax trees: skipped are the paths in
    both whose shapes (or kinds) differ."""
    if isinstance(dst, torch.nn.Module):
        module, state = dst, dst.state_dict()
    else:
        state = dict(dst)
    grafted = skipped = 0

    def rec(d: Mapping, s: Mapping) -> Dict:
        nonlocal grafted, skipped
        out = {}
        for k, v in d.items():
            if k not in s:
                out[k] = v
            elif isinstance(v, Mapping) and isinstance(s[k], Mapping):
                out[k] = rec(v, s[k])
            elif (not isinstance(v, Mapping) and hasattr(s[k], "shape")
                  and tuple(v.shape) == tuple(s[k].shape)):
                out[k] = torch.as_tensor(s[k]).to(v.dtype)
                grafted += 1
            else:
                out[k] = v
                skipped += 1
        return out

    tree = rec(torch_to_flax(state, module), src)
    return flax_to_torch(tree, module=module), grafted, skipped
