"""The dry run: each family's train step sharded over ranks.

Counterpart of ``__graft_entry__.py::dryrun_multichip``: for each family
at the dry run's shapes, the step of N ranks (each on its rows of the
global batch, parallel/mesh.py) is held against the port's one-process
step on the whole batch, from the same weights, batch and draws, at the
dry run's tolerances; the NFE must be equal, and the parameters after
the step bit-equal across the ranks. Then, where N is even and at least
4, the flagship's dp x tp step (``flagship_tp``: an (N/2, 2) ('data',
'model') mesh, the wide kernels' output channels sharded,
parallel/tp.py) and dp x sp step (``flagship_sp``: an (N/2, 2) ('data',
'space') mesh, the frame height sharded, parallel/sp.py), whose update
(the 'model' slices gathered) must also lie within ``PARAM_TOL``
relative L2 of the one-process step's. ``convgru_sp`` is ConvGRU's dp x
sp step (tests/test_mesh.py).

    python -m ode_rl_torch.parallel.dryrun --ranks 4 --device cpu

spawns gloo ranks on the CPU (the default, ``--device cuda``, puts every
rank on the one card, still over gloo), runs every family
(``--families`` to choose) and prints a line a family; it exits 1 on
any miss.
``run`` is the same from Python, with
``inputs`` (per family: ``weights``, a state dict per module; ``batch``;
``draws``, recorded (kind, array) draws of the global batch) to start
both steps from given weights and draws, as the tests give JAX's.

The families, with their sizes in the dry run: the flagship ODE-ConvGRU
(widths 64, 3 -> 3 frames, B=8, ode_max_steps 32), ConvGRU (16 channels,
3 -> 2, B=8), the Vid-ODE GAN, S3VAE, Dreamer, ConvLSTM (two small
stages), FlowNetC (full width, B=8) and the imagination behavior step;
``flagship_bench`` (``FlagshipConfig``: the fused step, B=128, bf16) and
``flownetc_bench`` (``FlowNetCBenchConfig``: the fused step, B=256,
bf16) are the card's full-width runs, and ``flagship_bench_tp`` and
``flagship_bench_sp`` the first on a 'model' or 'space' line.

Every process this starts is joined within ``timeout`` seconds or
killed; the process group is set up through a ``file://`` store in a
temporary directory, so no port is opened.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import functools
import hashlib
import json
import os
import pathlib
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

from ode_rl_torch.core.config import Config
from ode_rl_torch.core.noise import Noise, as_noise
from ode_rl_torch.parallel.mesh import (MODEL_AXIS, SPACE_AXIS, Mesh,
                                        gather_pytree, grid_mesh, make_mesh,
                                        replicate, shard_batch)
from ode_rl_torch.parallel.sp import shard_batch_sp
from ode_rl_torch.parallel.tp import shard_params_tp

SEED = 0
# Tolerances of ``dryrun_multichip`` (rtol, atol) by metric; the norm of
# every gradient an update takes at its grad_norm's 1e-4.
GRAD_TOL = (1e-4, 0.0)
LOSS_TOL = {"loss": (1e-5, 0.0), "grad_norm": GRAD_TOL}
GAN_TOL = {"d_loss": (1e-5, 1e-6), "g_loss": (1e-5, 1e-6),
           "d_grad_norm": GRAD_TOL, "g_grad_norm": GRAD_TOL}
DREAMER_TOL = {"loss": (5e-4, 1e-4), "kl": (5e-4, 1e-4),
               "image_loss": (5e-4, 1e-4), "grad_norm": GRAD_TOL}
FLOW_TOL = {"loss": (1e-5, 1e-6), "epe": (1e-5, 1e-6),
            "grad_norm": GRAD_TOL}
BEHAVIOR_TOL = {**{k: (2e-4, 1e-5) for k in (
    "actor_loss", "value_loss", "reward_mean", "actor_ent", "target_mean")},
    "actor_grad_norm": GRAD_TOL, "value_grad_norm": GRAD_TOL}
# The card's bf16 runs: two ranks against one on the same card, in
# another order of summation (K2's bf16 weight gradient rounded on each
# rank, then added). Set from the H100 readings, two ranks against one:
# flagship_bench grad_norm 1.2e-4 off and loss equal to six digits;
# flownetc_bench grad_norm 4.8e-5, EPE 1.2e-6.
BENCH_TOL = {"loss": (1e-4, 0.0), "grad_norm": (1e-3, 0.0)}
FLOW_BENCH_TOL = {"loss": (1e-4, 0.0), "epe": (1e-4, 0.0),
                  "grad_norm": (5e-4, 0.0)}
# The update of the parameters by the 'model' and 'space' steps (the
# slices gathered) against the one-process step's, relative L2. Adam's
# first step moves each parameter by about lr * sign(g), whatever |g|, so
# a leaf whose small gradient moves (a ReLU input at exactly 0 in one
# order of summation and 1e-9 in another) moves its whole update: an
# elementwise limit would hold the optimizer's conditioning, not the
# sharding. Readings on the CPU from JAX's init (tests/
# test_torch_port_parallel_{ode,rnn}.py): flagship_tp 4.2e-6,
# flagship_sp 1.24e-3 (its decode field's first kernel, gradient norm
# 8e-5, 1.3e-3 off, as the ReLUs at exact zeros move), convgru_sp
# 9.7e-6; from the dry run's seeded init 5.0e-6, 9.7e-6 and 1.0e-5.
PARAM_TOL = 5e-3
# flagship_bench on a 1 x 2 ('data', 'model') or ('data', 'space') mesh,
# two gloo ranks on one card, against one rank. Set from the H100
# readings: loss 1.3e-7 ('model') and 3.3e-7 ('space') off, grad_norm
# 1.27e-4 and 1.6e-3 (in bf16 every layer's roundings move as the
# moments-in K3/K4 and the halo tiles sum in another order, and ten
# ConvGRU steps carry them; 'data' read 1.24e-4); the update 0.0803 and
# 0.0793 relative L2, as a 'data' line of two reads (0.0797): in bf16 a
# gradient element's sign is noise where its sum cancels, and Adam's
# first step moves it by lr whatever its size.
AXIS_BENCH_TOL = {"loss": (1e-4, 0.0), "grad_norm": (5e-3, 0.0)}
BENCH_PARAM_TOL = 0.15


@dataclasses.dataclass(frozen=True)
class Family:
    build: Callable[[torch.device], Any]              # state from SEED
    batch: Callable[[torch.device], Dict]             # the global batch
    step: Callable[[Any, Dict, Any, Optional[Mesh]], Dict]
    modules: Callable[[Any], Dict[str, nn.Module]]
    tol: Dict[str, tuple]
    batch_size: int
    stochastic: bool = False
    # The mesh's second axis (lines of AXIS_RANKS), None for 'data' alone,
    # and the largest difference allowed between the parameters after
    # the sharded step (gathered) and after the one-process step.
    axis: Optional[str] = None
    param_tol: Optional[float] = None


# Ranks a 'model' or 'space' line, as dryrun_multichip's meshes.
AXIS_RANKS = 2


class Recorded(Noise):
    """Draws given in advance, handed out in order, each checked for its
    kind and shape (made at the global batch's shapes)."""

    def __init__(self, draws: Sequence, device: torch.device):
        super().__init__(None)
        self.draws, self.device = list(draws), device

    def _next(self, kind: str, shape) -> torch.Tensor:
        if not self.draws:
            raise ValueError(f"no recorded draw left for {kind} "
                             f"{tuple(shape)}")
        got, a = self.draws.pop(0)
        if got != kind or tuple(a.shape) != tuple(shape):
            raise ValueError(f"recorded {got} {tuple(a.shape)}, asked for "
                             f"{kind} {tuple(shape)}")
        return torch.as_tensor(np.array(a), device=self.device)

    def permutation(self, n, device):
        return self._next("permutation", (n,)).long()

    def normal(self, shape, like):
        return self._next("normal", shape).to(like.dtype)

    def gumbel(self, shape, like):
        return self._next("gumbel", shape).to(like.dtype)

    def uniform(self, shape, device, low=0.0, high=1.0):
        return self._next("uniform", shape).float()

    def randint(self, low, high, shape, device):
        return self._next("randint", shape).long()

    def _keep_mask(self, shape, keep, device):
        raise ValueError("dropout masks are not recorded")


# -- the families -----------------------------------------------------------

def _cpu_gen() -> torch.Generator:
    return torch.Generator().manual_seed(SEED)


def _video_batch(b: int, t_in: int, t_out: int, size: int = 64, **kw):
    from ode_rl_torch.data.protocol import make_batch_dict

    def make(device):
        v = torch.rand((b, t_in + t_out, size, size, 1),
                       generator=_cpu_gen()) - 0.5
        return make_batch_dict(v.to(device), n_in=t_in, **kw)

    return make


def _train_state(model_fn: Callable[[], nn.Module], cfg: Dict):
    from ode_rl_torch.train.step import TrainState, make_optimizer

    def build(device):
        model = model_fn().to(device)
        c = Config(cfg)
        return TrainState(model, make_optimizer(c, model.parameters()),
                          clip=float(c.get("clip", -1)))

    return build


def _train_step(state, batch, noise, mesh):
    from ode_rl_torch.train.step import train_step
    return train_step(state, batch, noise, mesh=mesh)


def _model(state) -> Dict[str, nn.Module]:
    return {"model": state.model}


def _grad_norm(module: nn.Module) -> torch.Tensor:
    """The global norm of the gradients ``module``'s last update took
    (averaged over the ranks under a mesh)."""
    from ode_rl_torch.train.step import global_norm
    return global_norm(p.grad for p in module.parameters()
                       if p.grad is not None)


def _flagship() -> Family:
    from ode_rl_torch.models.odeconvgru import ODEConvGRUModel
    return Family(
        _train_state(lambda: ODEConvGRUModel(
            in_channels=1, conv_encoder_out_ch=64,
            neural_ode_decoder_out_ch=64, neural_ode_n_units=64,
            n_ode_layers=1, ode_max_steps=32, generator=_cpu_gen()),
            {"lr": 1e-3, "clip": -1}),
        _video_batch(8, 3, 3), _train_step, _model, LOSS_TOL, 8)


def _convgru() -> Family:
    from ode_rl_torch.models.convgru import ConvGRUModel
    return Family(
        _train_state(lambda: ConvGRUModel(
            in_channels=1, conv_encoder_out_ch=16, convgru_out_ch=16,
            generator=_cpu_gen()), {"lr": 1e-3, "clip": -1}),
        _video_batch(8, 3, 2), _train_step, _model, LOSS_TOL, 8)


def _gan() -> Family:
    from ode_rl_torch.models.vidode import VidODEModel
    from ode_rl_torch.nn.discriminators import (PatchDiscriminator,
                                                seq_channels)
    from ode_rl_torch.train.gan import (GANState, make_gan_lr_schedule,
                                        make_gan_train_step)

    def build(device):
        g = _cpu_gen()
        gen = VidODEModel(in_channels=1, n_downs=1, n_layers=1,
                          ode_max_steps=16, rtol=1e-3, atol=1e-4,
                          generator=g)
        disc = nn.ModuleDict({
            "image": PatchDiscriminator(1, generator=g),
            "seq": PatchDiscriminator(seq_channels(3, 3, 1, True),
                                      generator=g)})
        return GANState(gen.to(device), disc.to(device), make_gan_lr_schedule(
            Config({"lr": 8e-4, "lr_decay": 0.99}), 10))

    def step(state, batch, noise, mesh):
        metrics = make_gan_train_step(extrap=True, lamb_adv=0.003,
                                      mesh=mesh)(state, batch, noise)
        return {**metrics, "d_grad_norm": _grad_norm(state.disc),
                "g_grad_norm": _grad_norm(state.gen)}

    return Family(build, _video_batch(8, 3, 3), step,
                  lambda s: {"gen": s.gen, "disc": s.disc}, GAN_TOL, 8)


def _s3vae() -> Family:
    from ode_rl_torch.models.s3vae import S3VAEModel
    return Family(
        _train_state(lambda: S3VAEModel(
            in_channels=1, d_zf=32, d_zt=8, encoder_out_dims=32,
            extrapolate=True, generator=_cpu_gen()),
            {"lr": 1e-3, "clip": -1}),
        _video_batch(8, 3, 3, with_flow_labels=True), _train_step, _model,
        LOSS_TOL, 8, stochastic=True)


def _dreamer() -> Family:
    from ode_rl_torch.wm.world_model import DreamerVideoModel
    return Family(
        _train_state(lambda: DreamerVideoModel(
            image_shape=(64, 64, 1), cnn_depth=8, stoch=8, deter=16,
            hidden=16, generator=_cpu_gen()), {"lr": 3e-4, "clip": 100}),
        _video_batch(8, 3, 3), _train_step, _model, DREAMER_TOL, 8,
        stochastic=True)


def _convlstm() -> Family:
    from ode_rl_torch.models.convlstm import ConvLSTMED
    return Family(
        _train_state(lambda: ConvLSTMED(
            1, (((8, 3, 2), 16), ((16, 3, 2), 16)), ((16, 4, 2),),
            generator=_cpu_gen()),
            {"lr": 1e-4, "clip": -1, "optimizer": "adamax"}),
        _video_batch(8, 3, 3), _train_step, _model, LOSS_TOL, 8)


def _flow_step(state, batch, noise, mesh):
    from ode_rl_torch.flow.train import make_flow_train_step
    _, step = make_flow_train_step(state.model, lr=1e-4, mesh=mesh)
    return step(state, (batch["img1"], batch["img2"]), batch["flow"])


def _on_axis(family: Callable[[], Family], axis: str, param_tol: float,
             tol: Optional[Dict[str, tuple]] = None) -> Callable[[], Family]:
    def make() -> Family:
        fam = family()
        return dataclasses.replace(fam, axis=axis, param_tol=param_tol,
                                   tol=tol or fam.tol)
    return make


def _flownetc() -> Family:
    from ode_rl_torch.data.sprites import get_sprite_bank
    from ode_rl_torch.flow.flownets import FlowNetC
    from ode_rl_torch.flow.train import make_flow_train_step, \
        synthetic_flow_batch

    def build(device):
        model = FlowNetC(generator=_cpu_gen()).to(device)
        return make_flow_train_step(model, lr=1e-4)[0]()

    def batch(device):
        bank = torch.from_numpy(get_sprite_bank()).float()
        img1, img2, flow = synthetic_flow_batch(_cpu_gen(), bank, batch=8)
        return {"img1": img1.to(device), "img2": img2.to(device),
                "flow": flow.to(device)}

    return Family(build, batch, _flow_step, _model, FLOW_TOL, 8)


class LinearDynamics(nn.Module):
    """The dry run's stand-in world model for the behavior step: stoch'
    = tanh(stoch + action . w_act), deter kept; reward the sum of the
    stochastic features. It draws nothing."""

    def __init__(self, action_dim: int = 2, stoch: int = 8):
        super().__init__()
        self.stoch = stoch
        self.register_buffer("w_act", 0.1 * torch.randn(
            action_dim, stoch, generator=torch.Generator().manual_seed(9)))

    def img_step(self, state, noise, action):
        return {"stoch": torch.tanh(state["stoch"] + action @ self.w_act),
                "deter": state["deter"]}

    @staticmethod
    def get_feat(state):
        return torch.cat([state["stoch"], state["deter"]], dim=-1)

    def reward(self, feats, states, actions):
        return torch.sum(feats[..., :self.stoch], dim=-1)


def _behavior() -> Family:
    from ode_rl_torch.wm.behavior import ImagBehavior

    def build(device):
        beh = ImagBehavior(2, 24, actor_dist="tanh_normal", horizon=4,
                           units=32, layers=2, slow_target_update=2,
                           generator=_cpu_gen())
        return {"behavior": beh.to(device),
                "world": LinearDynamics().to(device)}

    def batch(device):
        stoch = torch.randn((8, 8), generator=_cpu_gen())
        return {"stoch": stoch.to(device), "deter": torch.zeros(
            (8, 16), device=device)}

    def step(state, batch, noise, mesh):
        world, beh = state["world"], state["behavior"]
        metrics = beh.train_step(
            batch, world.img_step, world.get_feat, world.reward,
            as_noise(noise, "the behavior step"), mesh=mesh)
        return {**metrics, "actor_grad_norm": _grad_norm(beh.actor),
                "value_grad_norm": _grad_norm(beh.value)}

    return Family(build, batch, step, dict, BEHAVIOR_TOL, 8,
                  stochastic=True)


@functools.lru_cache(maxsize=None)
def _bank(data_dir: Optional[str], device: str) -> torch.Tensor:
    from ode_rl_torch.data.sprites import get_sprite_bank
    return torch.from_numpy(get_sprite_bank(data_dir)).float().to(device)


def _seeded(batch: Dict) -> torch.Generator:
    seed = batch["seed"]
    return torch.Generator(device=seed.device).manual_seed(int(seed))


def _seed_batch(device) -> Dict:
    return {"seed": torch.tensor(1, device=device)}


def _flagship_bench() -> Family:
    from ode_rl_torch.config import FlagshipConfig
    from ode_rl_torch.train.step import (create_train_state,
                                         make_fused_train_step)
    cfg = FlagshipConfig()

    def step(state, batch, noise, mesh):
        bank = _bank(cfg.data_dir, str(batch["seed"].device))
        return make_fused_train_step(cfg, bank, mesh=mesh)(state,
                                                           _seeded(batch))

    return Family(lambda device: create_train_state(cfg, device),
                  _seed_batch, step, _model, BENCH_TOL, cfg.batch_size)


def _flownetc_bench() -> Family:
    from ode_rl_torch.config import FlowNetCBenchConfig
    from ode_rl_torch.flow.flownets import FlowNetC
    from ode_rl_torch.flow.train import (make_flow_train_step,
                                         make_fused_flow_train_step)
    cfg = FlowNetCBenchConfig()

    def build(device):
        model = FlowNetC(cfg.max_displacement, cfg.corr_stride,
                         dtype=getattr(torch, cfg.dtype),
                         generator=torch.Generator().manual_seed(cfg.seed))
        return make_flow_train_step(model.to(device), lr=cfg.lr)[0]()

    def step(state, batch, noise, mesh):
        bank = _bank(None, str(batch["seed"].device))
        _, fused = make_fused_flow_train_step(
            state.model, bank, cfg.batch, lr=cfg.lr, loss_norm=cfg.loss_norm,
            single_scale=cfg.single_scale, mesh=mesh)
        return fused(state, _seeded(batch))

    return Family(build, _seed_batch, step, _model, FLOW_BENCH_TOL,
                  cfg.batch)


FAMILIES = {"flagship": _flagship, "convgru": _convgru, "gan": _gan,
            "s3vae": _s3vae, "dreamer": _dreamer, "convlstm": _convlstm,
            "flownetc": _flownetc, "behavior": _behavior,
            "flagship_bench": _flagship_bench,
            "flownetc_bench": _flownetc_bench,
            "flagship_tp": _on_axis(_flagship, MODEL_AXIS, PARAM_TOL),
            "flagship_sp": _on_axis(_flagship, SPACE_AXIS, PARAM_TOL),
            "convgru_sp": _on_axis(_convgru, SPACE_AXIS, PARAM_TOL),
            "flagship_bench_tp": _on_axis(_flagship_bench, MODEL_AXIS,
                                          BENCH_PARAM_TOL, AXIS_BENCH_TOL),
            "flagship_bench_sp": _on_axis(_flagship_bench, SPACE_AXIS,
                                          BENCH_PARAM_TOL, AXIS_BENCH_TOL)}
DRYRUN = ("flagship", "convgru", "gan", "s3vae", "dreamer", "convlstm",
          "flownetc", "behavior")
# dryrun_multichip's dp x tp and dp x sp flagship steps, after the data-
# parallel families where the ranks split into lines of AXIS_RANKS.
DRYRUN_AXES = ("flagship_tp", "flagship_sp")


# -- one family on one rank -------------------------------------------------

def _floats(metrics: Dict) -> Dict:
    return {k: (v.item() if torch.is_tensor(v) else v)
            for k, v in metrics.items()
            if (torch.is_tensor(v) and v.numel() == 1)
            or isinstance(v, (int, float))}


def _flat(modules: Dict[str, nn.Module]) -> torch.Tensor:
    """Every floating parameter and buffer of ``modules``, flattened in
    fp64."""
    return torch.cat([t.detach().double().reshape(-1)
                      for m in modules.values()
                      for t in m.state_dict().values()
                      if t.is_floating_point()])


def _digest(states: Dict[str, Dict[str, torch.Tensor]]) -> str:
    h = hashlib.sha256()
    for name in sorted(states):
        for key, t in states[name].items():
            h.update(key.encode())
            h.update(t.detach().cpu().contiguous().view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profiled(fn: Callable, device: torch.device) -> Dict:
    """One call of ``fn`` under torch.profiler: device ms in all, by
    kernel group, and each K1-K8 kernel's launches and µs a launch
    (``profile_step``'s groups and names)."""
    from ode_rl_torch.profile_step import _KERNEL_NAME, _group
    _sync(device)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(device)
    groups, kernels = {}, {}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or e.key.startswith(
                ("Optimizer.", "ProfilerStep")):
            continue
        group = _group(e.key)
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3
        found = _KERNEL_NAME.search(e.key)
        if found:
            kernels[found.group(0)] = [e.count,
                                       e.self_device_time_total / e.count]
    return {"device_ms": sum(groups.values()), "groups": groups,
            "kernels": kernels}


def _run_family(name: str, given: Optional[Dict], mesh: Mesh,
                single: bool, timed_steps: int,
                profile: bool = False) -> Dict:
    from ode_rl_torch.ops import common

    fam = FAMILIES[name]()
    given = given or {}
    device = mesh.device

    def fresh(shared: bool):
        state = fam.build(device)
        for key, module in fam.modules(state).items():
            if "weights" in given:
                module.load_state_dict(given["weights"][key])
            if shared:
                replicate(module, mesh)
                if fam.axis == MODEL_AXIS:
                    shard_params_tp(module, mesh, min_channels=64)
        return state

    def noise():
        if "draws" in given:
            return Recorded(given["draws"], device)
        if fam.stochastic:
            return torch.Generator(device=device).manual_seed(SEED + 1)
        return None

    def run(state, batch, m):
        n = noise()
        metrics = fam.step(state, batch, n, m)
        if isinstance(n, Recorded) and n.draws:
            raise ValueError(f"{name}: {len(n.draws)} recorded draws unused")
        return metrics

    batch = ({k: torch.as_tensor(np.asarray(v), device=device)
              for k, v in given["batch"].items()} if "batch" in given
             else fam.batch(device))
    rows = (shard_batch_sp(batch, mesh) if fam.axis == SPACE_AXIS
            and "observed_data" in batch
            else shard_batch(batch, mesh, fam.batch_size))
    state = fresh(shared=True)
    common.reset_launches()
    mesh.moved = {}
    metrics = run(state, rows, mesh)
    out = {"sharded": _floats(metrics), "grad_bytes": mesh.grad_bytes,
           "moved_bytes": dict(mesh.moved)}
    # The parameters after the step, the 'model' slices gathered whole.
    after = {key: {k: t.detach().clone() for k, t in
                   gather_pytree(module, mesh).items()}
             for key, module in fam.modules(state).items()}
    gathered = [None] * mesh.world
    dist.all_gather_object(gathered, {
        "digest": _digest(after), "launches": dict(common.launches),
        "halo_heights": sorted(common.halo_heights)})
    out["params_equal"] = len({g["digest"] for g in gathered}) == 1
    out["rank_launches"] = [g["launches"] for g in gathered]
    out["rank_halo_heights"] = [g["halo_heights"] for g in gathered]
    out["step_ms"] = _times(lambda: run(state, rows, mesh), timed_steps,
                            device)
    if profile:
        out["profile"] = _profiled(lambda: run(state, rows, mesh), device)
    if single:
        one = fresh(shared=False)
        before = _flat(fam.modules(one))
        out["single"] = _floats(run(one, batch, None))
        single_after = _flat(fam.modules(one))
        sharded_after = torch.cat([after[key][k].double().reshape(-1)
                                   for key, m in fam.modules(one).items()
                                   for k, t in m.state_dict().items()
                                   if t.is_floating_point()])
        out["update_rel_l2"] = (
            torch.linalg.vector_norm(sharded_after - single_after)
            / torch.linalg.vector_norm(single_after - before)).item()
        out["single_step_ms"] = _times(lambda: run(one, batch, None),
                                       timed_steps, device)
    return out


def _times(fn: Callable, n: int, device: torch.device) -> List[float]:
    """ms of ``n`` calls of ``fn``, each closed by a synchronize."""
    out = []
    for _ in range(n):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _worker(rank: int, world: int, store: str, device: str,
            backend: Optional[str], families: List[str],
            inputs_path: Optional[str], out_dir: str, timed_steps: int,
            threads: int, cudnn: bool = True, profile: bool = False) -> None:
    torch.set_num_threads(threads)
    # Strict fp32 on the card, as on the CPU: the ranks' convs must not
    # round to TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = cudnn
    mesh = make_mesh(backend=backend, device=torch.device(device),
                     init_method=f"file://{store}", rank=rank,
                     world_size=world,
                     timeout=datetime.timedelta(seconds=60))
    inputs = (torch.load(inputs_path, weights_only=False) if inputs_path
              else {})
    results = {}
    meshes = {None: mesh}
    try:
        for i, name in enumerate(families):
            axis = FAMILIES[name]().axis
            if axis not in meshes:   # every rank, in the families' order
                meshes[axis] = grid_mesh(mesh, axis, AXIS_RANKS)
            # The one-process steps are spread over the ranks.
            results[name] = _run_family(name, inputs.get(name),
                                        meshes[axis],
                                        single=(i % world == rank),
                                        timed_steps=timed_steps,
                                        profile=profile)
        pathlib.Path(out_dir, f"rank{rank}.json").write_text(
            json.dumps(results))
        mesh.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(fn: Callable, args: tuple, ranks: int, timeout: float) -> None:
    """``fn(rank, *args)`` in ``ranks`` spawned processes, joined within
    ``timeout`` seconds or killed."""
    ctx = mp.start_processes(fn, args=args, nprocs=ranks, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {ranks} ranks did not finish "
                                   f"within {timeout:.0f} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()


def run(families: Sequence[str] = DRYRUN, ranks: int = 4,
        device: str = "cuda", backend: Optional[str] = None,
        inputs: Optional[Dict] = None, timed_steps: int = 0, threads: int = 1,
        timeout: float = 600.0, cudnn: bool = True,
        profile: bool = False) -> Dict[str, Dict]:
    """Run ``families`` over ``ranks`` spawned processes; returns, per
    family, the sharded step's metrics (``sharded``), the one-process
    step's (``single``), ``params_equal``, each rank's kernel launches
    (``rank_launches``) and the H of its K1/K2 launches with a halo operand
    (``rank_halo_heights``), the gradient all-reduce's bytes, the bytes rank
    0 sent into the collectives of its first step by axis
    (``moved_bytes``), the relative L2 of the step's update against the
    one-process step's (``update_rel_l2``) and the timed steps' ms.
    ``cudnn`` False runs the convs outside the repo's kernels on
    PyTorch's own CUDA convolution instead of cuDNN's, on every rank and
    in the one-process step alike. ``profile`` adds one more sharded
    step under torch.profiler on every rank, rank 0's device time by
    kernel group and kernel (``profile``)."""
    for name in families:
        if name not in FAMILIES:
            raise ValueError(f"unknown family {name!r}: {sorted(FAMILIES)}")
    with tempfile.TemporaryDirectory() as tmp:
        inputs_path = None
        if inputs:
            inputs_path = str(pathlib.Path(tmp, "inputs.pt"))
            torch.save(inputs, inputs_path)
        _spawn(_worker, (ranks, str(pathlib.Path(tmp, "store")), device,
                         backend, list(families), inputs_path, tmp,
                         timed_steps, threads, cudnn, profile),
               ranks, timeout)
        parts = [json.loads(pathlib.Path(tmp, f"rank{r}.json").read_text())
                 for r in range(ranks)]
    results = parts[0]
    for part in parts[1:]:
        for name, res in part.items():
            for key in ("single", "single_step_ms", "update_rel_l2"):
                if key in res:
                    results[name][key] = res[key]
    return results


def _main_worker(rank: int, world: int, store: str, argv: List[str],
                 out_dir: str, threads: int) -> None:
    from ode_rl_torch.main import main
    torch.set_num_threads(threads)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = main(argv)
        pathlib.Path(out_dir, f"main{rank}.json").write_text(json.dumps(
            {k: v for k, v in out.items() if isinstance(v, (int, float))}))
    finally:
        dist.destroy_process_group()


def run_main(argv: Sequence[str], ranks: int = 2, threads: int = 1,
             timeout: float = 600.0) -> List[Dict]:
    """``ode_rl_torch.main`` with ``argv`` over ``ranks`` gloo processes,
    as torchrun would start it (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``),
    the group joined through a ``file://`` store; returns each rank's
    scalar results."""
    with tempfile.TemporaryDirectory() as tmp:
        _spawn(_main_worker, (ranks, str(pathlib.Path(tmp, "store")),
                              list(argv), tmp, threads), ranks, timeout)
        return [json.loads(pathlib.Path(tmp, f"main{r}.json").read_text())
                for r in range(ranks)]


def _probe_worker(rank: int, world: int, store: str, device: str,
                  out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device(device)
    mine = lambda: torch.full((4,), float(rank + 1), device=dev)
    ranks = [float(r + 1) for r in range(world)]

    def all_reduce():
        x = mine()
        dist.all_reduce(x)
        return float(x[0]) == sum(ranks)

    def broadcast():
        x = mine()
        dist.broadcast(x, 0)
        return float(x[0]) == ranks[0]

    def all_gather():
        x = mine()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return [float(p[0]) for p in parts] == ranks

    found = {}
    try:
        for name, op in (("all_reduce", all_reduce), ("broadcast", broadcast),
                         ("all_gather", all_gather)):
            try:
                found[name] = "accepted" if op() else "accepted, wrong values"
            except (RuntimeError, ValueError) as e:
                found[name] = "refused: " + str(e).splitlines()[0][:160]
        pathlib.Path(out_dir, f"probe{rank}.json").write_text(
            json.dumps(found))
    finally:
        dist.destroy_process_group()


def gloo_device_probe(device: str, ranks: int = 2,
                      timeout: float = 120.0) -> Dict[str, str]:
    """Which gloo collectives take tensors on ``device`` as they are and
    give the right values (the mesh hands them CUDA tensors where its
    ranks share a card): op -> 'accepted' or why not, as rank 0 saw
    it."""
    with tempfile.TemporaryDirectory() as tmp:
        _spawn(_probe_worker, (ranks, str(pathlib.Path(tmp, "store")),
                               device, tmp), ranks, timeout)
        return json.loads(pathlib.Path(tmp, "probe0.json").read_text())


def misses(name: str, result: Dict, reference: Dict,
           tol: Optional[Dict] = None) -> List[str]:
    """The metrics of ``result['sharded']`` that miss ``reference`` at the
    family's tolerances, an NFE that differs, and unequal parameters."""
    tol = FAMILIES[name]().tol if tol is None else tol
    out = []
    got = result["sharded"]
    for key, (rtol, atol) in tol.items():
        a, b = got[key], reference[key]
        if not abs(a - b) <= atol + rtol * abs(b):
            out.append(f"{key} {a!r} vs {b!r} (rtol {rtol}, atol {atol})")
    if "nfe" in reference and got.get("nfe") != reference["nfe"]:
        out.append(f"nfe {got.get('nfe')} vs {reference['nfe']}")
    if not result["params_equal"]:
        out.append("parameters differ across the ranks")
    param_tol = FAMILIES[name]().param_tol
    if param_tol is not None and not result["update_rel_l2"] <= param_tol:
        out.append(f"the step's update {result['update_rel_l2']!r} from "
                   f"the one-process step's, relative L2 (limit "
                   f"{param_tol})")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--families", nargs="+", default=None)
    parser.add_argument("--timeout", type=float, default=1200.0)
    args = parser.parse_args(argv)
    if args.families is None:
        args.families = list(DRYRUN) + (
            list(DRYRUN_AXES) if args.ranks % AXIS_RANKS == 0
            and args.ranks >= 4 else [])
    results = run(args.families, args.ranks, args.device,
                  backend="gloo", timeout=args.timeout)
    failed = False
    for name in args.families:
        res = results[name]
        bad = misses(name, res, res["single"])
        failed |= bool(bad)
        metrics = " ".join(f"{k}={res['sharded'][k]:.6g} (one process "
                           f"{res['single'][k]:.6g})"
                           for k in FAMILIES[name]().tol)
        nfe = (f" nfe={res['sharded']['nfe']}" if "nfe" in res["sharded"]
               else "")
        update = (f", update {res['update_rel_l2']:.3g} relative L2 from "
                  "the one-process step's" if FAMILIES[name]().axis
                  else "")
        print(f"dryrun({args.ranks}) {name}: "
              f"{'ok' if not bad else 'MISS ' + '; '.join(bad)} {metrics}"
              f"{nfe}, parameters bit-equal across ranks: "
              f"{res['params_equal']}{update}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
