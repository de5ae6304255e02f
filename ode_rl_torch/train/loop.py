"""Training and evaluation loop.

Counterpart of ``setup``, ``train``, ``train_gan`` and ``test`` in
``ode_rl_tpu/train/loop.py`` for the video-prediction families the port
builds (models/registry.py): the epoch x batch loop with loss logging at
``loss_log_freq``, checkpoints every ``ckpt_save_freq`` and at the end,
auto-resume from the newest checkpoint, the per-epoch line, and the test
protocol (restore by ``ckpt_id``, ``eval_batches`` batches, per-horizon
MSE/PSNR/SSIM, and LPIPS for Vid-ODE, into ``per_horizon.json``, the
last horizon as ``final_*``, and a prediction/ground-truth sheet
``pred_gt.png``).

Without a frozen corpus the train step makes its own batch on the device
(the fused step); with one, batches come from the loader. S3VAE's batches
carry its DFP labels (the frame-difference motion grid) on both paths and
in the test phase. With ``vidode_sampling`` each batch is a window of
``window_size`` frames (Moving MNIST clips of that length, or a video
corpus's), sampled and split by data/samplers.py from a generator seeded
from ``cfg.seed``. ``gan`` trains Vid-ODE adversarially (train/gan.py):
no resume, as in JAX; every ``gan_test_freq_epochs`` epochs an
evaluation over ``gan_eval_batches`` test batches writes its curves and a
sheet; its checkpoints hold ``gen_params``, ``gen_model_state`` and
``disc_params``, and its test phase restores the first two. Every train
and eval step draws any model noise (``z_sample``, S3VAE's, Vid-ODE's
slots) from one sampling generator seeded from ``cfg.seed``, as JAX
hands each step a key split from the run's. Metrics are fetched to the
host only at log points; a model's own metrics (``nfe``, ``z0_kl``,
``nan_skipped``, S3VAE's loss terms and so on) are logged with the loss.
Checkpoints hold the model's ``state_dict``, so BatchNorm's running
statistics go with the weights into the test phase.

A test block restores the train run's saved config for every key that is
not one of the evaluation protocol's, as JAX does: so
``test_mmnist_odecgrumem_len20_1ch``, which says ``n_ode_layers: 2``,
builds the 3 layers its train block saved, and its checkpoint loads.

With ``lr_scheduler: plateau`` or ``early_stop_patience`` > 0 the loop
monitors, once an epoch, the mean eval-mode MSE over ``val_batches``
batches of the test loader drawn once before training (split at
``train_in_seq``, as JAX splits them), logs it as ``val_mse``, scales
every param group's lr by the plateau's scale (train/schedulers.py;
the optimizer's ``state_dict`` carries it into checkpoints) and stops
early when the metric stalls. ``debug_nans`` raises
``FloatingPointError`` at a train step whose forward or backward makes a
NaN, and at a test batch whose prediction or metrics hold one
(core/debug.py).

``model: CATERClassifier`` trains and tests through its own path
(wm/cater.py), as JAX's ``train`` (after the GAN's) and ``test`` (before
any checkpoint is resolved) send it.

``flow_label_source: flownet`` gives S3VAE's training batches (fused or
from the loader) and its validation batches the DFP labels of FlowNetC's
predicted flow (data/flow_labels.py): an fp32 FlowNetC on the run's
device, as JAX builds ``FlowNetC()`` at its fp32 default whatever the
run's dtype, with the weights in ``flownet_params_path`` (JAX's or the
port's file, flow/train.py); without that file it raises, unless
``allow_random_flownet`` opts into a randomly initialised net with a
warning. The test phase keeps the frame-difference labels, as JAX's
does. The metric-vs-horizon plot (matplotlib) is not written.

``use_mesh`` trains data-parallel (parallel/mesh.py) over the ranks
torchrun starts, one a card (``python -m torch.distributed.run
--nproc_per_node N -m ode_rl_torch.main ... --use_mesh True``), or gloo
ranks on the CPU with ``--device cpu``. ``batch_size`` stays the global
batch: every rank makes or reads it from the same generators and trains
on its rows, so the step is the one-process step on the whole batch.
Rank 0 alone writes logs and checkpoints, between barriers; on resume
every rank reads the checkpoint; the validation monitor runs on every
rank over the whole batches, so every rank takes the same decision. As
in JAX, the GAN and CATER paths return before the mesh is built, and the
test phase runs on one process: ``use_mesh`` changes neither.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Optional

import numpy as np
import torch

from ode_rl_torch.core.checkpoint import CheckpointManager, find_checkpoint
from ode_rl_torch.core.config import Config, resolve_run_id
from ode_rl_torch.core.debug import check_finite
from ode_rl_torch.core.logging import MetricLogger
from ode_rl_torch.core.noise import Noise
from ode_rl_torch.data.flow_labels import make_flownet_label_fn
from ode_rl_torch.data.mmnist import MovingMNIST, parse_datasets
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.data.samplers import sample, split_batch
from ode_rl_torch.data.sprites import get_sprite_bank
from ode_rl_torch.eval_models.lpips import lpips_horizon_fn
from ode_rl_torch.flow.flownets import FlowNetC
from ode_rl_torch.flow.train import load_flax_params, load_flownet_params
from ode_rl_torch.parallel.mesh import Mesh, make_mesh, replicate, shard_batch
from ode_rl_torch.train.gan import create_gan_state, make_gan_train_step
from ode_rl_torch.train.schedulers import (EarlyStopping, ReduceLROnPlateau,
                                           set_lr_scale)
from ode_rl_torch.train.step import (TrainState, create_train_state,
                                     make_eval_step, make_fused_train_step,
                                     make_train_step, needs_flow_labels)
from ode_rl_torch.train.visualize import save_filmstrip
from ode_rl_torch.wm.cater import eval_cater_classifier, train_cater_classifier

# The fused loop's generator seed is the run seed plus this (JAX folds
# the same constant into its loop key).
_LOOP_SEED = 0xDA7A
# The sampling generator's seed is the run seed plus this.
_SAMPLE_SEED = 0x5A3D
# The window samplers' generator's seed is the run seed plus this.
_WINDOW_SEED = 0x3D1D


def _sample_generator(cfg, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        int(cfg.get("seed", 0)) + _SAMPLE_SEED)


def _make_flow_label_fn(cfg, device: torch.device):
    """S3VAE's DFP label source: None for the frame-difference labels;
    for ``flow_label_source: flownet`` the labels of FlowNetC's flow."""
    if cfg.get("flow_label_source", "diff") != "flownet":
        return None
    net = FlowNetC(generator=torch.Generator().manual_seed(0)).to(device)
    net.requires_grad_(False)
    path = str(cfg.get("flownet_params_path", "") or "")
    if path and pathlib.Path(path).exists():
        load_flax_params(net, load_flownet_params(path)["params"])
        print(f"flow labels: FlowNetC weights from {path}")
    elif cfg.get("allow_random_flownet", False):
        print("warning: flow_label_source=flownet with "
              "allow_random_flownet=True — DFP labels come from a "
              "randomly initialized FlowNetC (debug only)")
    else:
        # The reference's DFP labels come from a trained flow net; labels
        # from random-feature flow would be noise.
        raise FileNotFoundError(
            f"flow_label_source=flownet but no trained weights at "
            f"flownet_params_path={path!r}. Train them with "
            f"`python -m ode_rl_torch.train_flownetc` (writes the default "
            f"path), or pass --allow_random_flownet True to opt into "
            f"random-init flow features.")
    return make_flownet_label_fn(net)


def setup(cfg, device: torch.device):
    """Loaders and the initial state. One batch is drawn and dropped, as
    JAX draws its init sample, so both read the same batches after."""
    loaders = parse_datasets(cfg, device)
    loader = (loaders["train_dataloader"] if cfg.phase == "train"
              else loaders["test_dataloader"])
    next(loader)
    return loaders, create_train_state(cfg, device)


def _snapshot(state: TrainState) -> Dict:
    return {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict()}


def _load(state: TrainState, snapshot: Dict) -> None:
    state.model.load_state_dict(snapshot["model"])
    state.optimizer.load_state_dict(snapshot["optimizer"])


def _window_batches(cfg, loader):
    """A function that gives the next batch of Vid-ODE's window sampling:
    a clip of ``loader``, sampled (``sample_size`` train_in_seq +
    train_out_seq) and split."""
    noise = Noise(torch.Generator().manual_seed(int(cfg.get("seed", 0))
                                                + _WINDOW_SEED))
    extrap = cfg.get("extrapolate", True)

    def next_batch() -> Dict:
        frames, mask = sample(
            noise, next(loader),
            sample_size=cfg.train_in_seq + cfg.train_out_seq,
            window_size=int(cfg.get("window_size", cfg.train_seq)),
            irregular=cfg.get("irregular", False), extrap=extrap,
            train=True)
        return split_batch(frames, mask, extrap=extrap)

    return next_batch


def _make_mesh(cfg, device: torch.device) -> Optional[Mesh]:
    """The data-parallel mesh where ``use_mesh`` asks for it: torchrun's
    ranks, on ``device`` where it is the CPU (gloo), else on the card of
    the rank's ``LOCAL_RANK`` (NCCL)."""
    if not cfg.get("use_mesh", False):
        return None
    mesh = make_mesh(device=device if device.type == "cpu" else None)
    mesh.rows(int(cfg.batch_size))      # the global batch must split
    return mesh


def _saver(ckpt: CheckpointManager, mesh: Optional[Mesh], lead: bool):
    """save(step, snapshot, config): rank 0 writes, every rank waits for
    the others before and after."""

    def save(step: int, snapshot: Dict, config: Dict) -> None:
        if mesh is not None:
            mesh.barrier()
        if lead:
            ckpt.save(step, snapshot, config=config)
        if mesh is not None:
            mesh.barrier()

    return save


def train(cfg, device: torch.device,
          logdir: Optional[pathlib.Path] = None) -> Dict:
    if cfg.get("gan", False):
        return train_gan(cfg, device, logdir)
    if cfg.model == "CATERClassifier":
        return train_cater_classifier(cfg, device, logdir)
    mesh = _make_mesh(cfg, device)
    if mesh is not None:
        device = mesh.device
    lead = mesh is None or mesh.rank == 0
    run_id = resolve_run_id(cfg)
    logdir = (pathlib.Path(logdir or cfg.get("logdir", "logs")) / cfg.model
              / run_id)
    logger = MetricLogger(logdir if lead else None,
                          use_wandb=lead and not cfg.get("off_wandb", True),
                          quiet=cfg.get("quiet", False) or not lead)
    ckpt = CheckpointManager(logdir / "checkpoints",
                             tag=cfg.get("ckpt_id", run_id))
    save = _saver(ckpt, mesh, lead)
    loaders, state = setup(cfg, device)
    if mesh is not None:
        replicate(state.model, mesh)

    windows = cfg.get("vidode_sampling", False)
    fused = (cfg.get("fused_datagen", True) and cfg.dataset == "mmnist"
             and not loaders.get("frozen", False) and not windows)
    loader = loaders["train_dataloader"]
    if windows and cfg.dataset == "mmnist":
        # Moving MNIST clips of the window's length.
        loader = MovingMNIST(
            batch_size=cfg.batch_size,
            n_frames_input=int(cfg.get("window_size", cfg.train_seq)),
            n_frames_output=0, num_digits=cfg.num_digits,
            data_dir=cfg.get("data_dir"), seed=cfg.get("seed", 0),
            device=device)
    next_window = _window_batches(cfg, loader) if windows else None
    flow_label_fn = (_make_flow_label_fn(cfg, device)
                     if needs_flow_labels(cfg) else None)
    if fused:
        bank = get_sprite_bank(cfg.get("data_dir"))
        if int(cfg.get("num_sprites", 0) or 0):
            bank = bank[:int(cfg.num_sprites)]
        fused_step = make_fused_train_step(
            cfg, torch.from_numpy(bank).float().to(device),
            flow_label_fn=flow_label_fn, mesh=mesh)
        loop_gen = torch.Generator(device=device).manual_seed(
            int(cfg.get("seed", 0)) + _LOOP_SEED)
    else:
        train_step = make_train_step(
            nan_guard=cfg.get("nan_guard", False),
            debug_nans=cfg.get("debug_nans", False), mesh=mesh)
    sample_gen = _sample_generator(cfg, device)
    n_train_batches = (int(cfg.get("steps_per_epoch", 0))
                       or loaders["n_train_batches"])
    total_steps = n_train_batches * cfg.epochs
    if lead:
        logger.print_exp_details(cfg, n_train_batches)

    start_step = 0
    if ckpt.latest_step() is not None and cfg.get("auto_resume", True):
        try:
            restored = ckpt.restore(_snapshot(state))
        except ValueError as e:
            # A snapshot of another architecture: refuse the resume.
            print(f"auto-resume skipped: {e}")
        else:
            _load(state, restored["state"])
            start_step = state.step = restored["step"]
            print(f"resumed from step {start_step}")

    plateau, early, val_monitor = _monitors(cfg, loaders, state, device,
                                            flow_label_fn)
    step = start_step
    last_metrics: Dict = {}
    log_freq = int(cfg.get("loss_log_freq", 50))
    for epoch in range(cfg.epochs):
        epoch_losses = []
        for _ in range(n_train_batches):
            if step >= total_steps:
                break
            if fused:
                metrics = fused_step(state, loop_gen, sample_gen)
            else:
                if windows:
                    batch = next_window()
                else:
                    # The global batch; a rank trains on its rows.
                    batch = make_batch_dict(
                        next(loader), n_in=cfg.train_in_seq,
                        with_flow_labels=needs_flow_labels(cfg),
                        flow_label_fn=flow_label_fn)
                if mesh is not None:
                    batch = shard_batch(batch, mesh)
                metrics = train_step(state, batch, sample_gen)
            step += 1
            # Fetch metrics only at log points.
            if step % log_freq == 0 or step == 1:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                logger.log(step, last_metrics)
                epoch_losses.append(last_metrics["loss"])
            if step % cfg.get("ckpt_save_freq", 5000) == 0:
                save(step, _snapshot(state), cfg.to_dict())
        epoch_loss = (float(np.mean(epoch_losses)) if epoch_losses
                      else last_metrics.get("loss", float("nan")))
        if lead:
            logger.log_epoch(epoch, epoch_loss, step, total_steps)
        if val_monitor is not None:
            val_mse = val_monitor()
            logger.log(step, {"val_mse": val_mse})
            if plateau is not None:
                prev = plateau.scale
                scale = plateau.step(val_mse)
                if scale != prev:
                    set_lr_scale(state.optimizer, float(cfg.lr), scale)
                    print(f"plateau: val_mse {val_mse:.6f} stalled — lr "
                          f"scale {prev:g} → {scale:g}")
            if early is not None and early.step(val_mse):
                print(f"early stop at epoch {epoch}: val_mse {val_mse:.6f} "
                      f"has not improved past {early.best:.6f} for "
                      f"{early.patience} epochs")
                break
        if step >= total_steps:
            break
    save(max(step, 1), _snapshot(state), cfg.to_dict())
    logger.close()
    return {"final_step": step, **last_metrics}


def _monitors(cfg, loaders: Dict, state: TrainState, device: torch.device,
              flow_label_fn=None):
    """(plateau, early stopping, the validation monitor), each None where
    the config does not ask for it. The monitor is the mean eval-mode MSE
    over the ``val_batches`` held-out batches (S3VAE's labels from
    ``flow_label_fn`` where it is given), the model's draws from a
    generator seeded 0 at every call (JAX passes key 0)."""
    plateau = early = None
    if cfg.get("lr_scheduler", "") == "plateau":
        plateau = ReduceLROnPlateau(
            factor=float(cfg.get("plateau_factor", 0.5)),
            patience=int(cfg.get("plateau_patience", 4)),
            min_scale=float(cfg.get("plateau_min_scale", 1e-3)))
    if int(cfg.get("early_stop_patience", 0)) > 0:
        early = EarlyStopping(patience=int(cfg.early_stop_patience))
    if plateau is None and early is None:
        return None, None, None
    eval_step = make_eval_step()
    val_batches = [
        make_batch_dict(next(loaders["test_dataloader"]),
                        n_in=cfg.train_in_seq,
                        with_flow_labels=needs_flow_labels(cfg),
                        flow_label_fn=flow_label_fn)
        for _ in range(int(cfg.get("val_batches", 2)))]

    def val_monitor() -> float:
        mses = [float(eval_step(state.model, vb, torch.Generator(
            device=device).manual_seed(0))[0]["mse"].mean())
            for vb in val_batches]
        return float(np.mean(mses))

    return plateau, early, val_monitor


def train_gan(cfg, device: torch.device,
              logdir: Optional[pathlib.Path] = None) -> Dict:
    """Adversarial Vid-ODE training (train/gan.py), as JAX's
    ``train_gan``."""
    run_id = resolve_run_id(cfg)
    logdir = (pathlib.Path(logdir or cfg.get("logdir", "logs")) / cfg.model
              / run_id)
    logger = MetricLogger(logdir, quiet=cfg.get("quiet", False))
    ckpt = CheckpointManager(logdir / "checkpoints",
                             tag=cfg.get("ckpt_id", run_id))
    loaders = parse_datasets(cfg, device)
    loader = loaders["train_dataloader"]
    sample_batch = make_batch_dict(next(loader), n_in=cfg.train_in_seq)
    n_batches = (int(cfg.get("steps_per_epoch", 0))
                 or loaders["n_train_batches"])
    extrap = bool(cfg.get("extrapolate", True))
    state = create_gan_state(cfg, device, sample_batch,
                             steps_per_epoch=n_batches, extrap=extrap)
    step_fn = make_gan_train_step(extrap=extrap,
                                  lamb_adv=float(cfg.get("lamb_adv", 0.003)))
    sample_gen = _sample_generator(cfg, device)
    eval_step = make_eval_step()
    test_loader = loaders.get("test_dataloader")
    test_freq = int(cfg.get("gan_test_freq_epochs", 100))

    def periodic_eval(epoch: int) -> Dict:
        """Metrics over ``gan_eval_batches`` test batches, their curves
        and a ground truth/prediction sheet of the last batch."""
        acc, pred, tbatch = [], None, None
        for _ in range(int(cfg.get("gan_eval_batches", 4))):
            tbatch = make_batch_dict(next(test_loader), n_in=cfg.train_in_seq)
            m, pred = eval_step(state.gen, tbatch, sample_gen)
            acc.append({k: _host(v) for k, v in m.items()
                        if not k.startswith("aux_")})
        m = {k: np.mean(np.stack([a[k] for a in acc]), axis=0)
             for k in acc[0]}
        (logdir / f"gan_eval_epoch{epoch:05d}.json").write_text(json.dumps(
            {k: v.tolist() for k, v in m.items()}))
        save_filmstrip(logdir / f"test_epoch{epoch:05d}.png",
                       [_host(tbatch["data_to_predict"][0]) + 0.5,
                        _host(pred[0])])
        return {f"test_{k}": float(v.mean()) for k, v in m.items()}

    total = n_batches * cfg.epochs
    step = 0
    last: Dict = {}
    log_freq = int(cfg.get("loss_log_freq", 50))
    for epoch in range(cfg.epochs):
        for _ in range(n_batches):
            if step >= total:
                break
            batch = make_batch_dict(next(loader), n_in=cfg.train_in_seq)
            metrics = step_fn(state, batch, sample_gen)
            step += 1
            if step % log_freq == 0 or step == 1:
                last = {k: float(v) for k, v in metrics.items()}
                logger.log(step, last)
            if step % cfg.get("ckpt_save_freq", 5000) == 0:
                ckpt.save(step, state.snapshot(), config=cfg.to_dict())
        if test_loader is not None and (epoch + 1) % test_freq == 0:
            test_metrics = periodic_eval(epoch + 1)
            last.update(test_metrics)
            logger.log(step, test_metrics)
    ckpt.save(max(step, 1), state.snapshot(), config=cfg.to_dict())
    logger.close()
    return {"final_step": step, **last}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# Keys the test block keeps when it resurrects a saved train config:
# those that define the evaluation protocol rather than the model.
_TEST_PROTOCOL_KEYS = frozenset({
    "id", "phase", "load_model", "ckpt_id", "ckpt_step", "logdir", "rundir",
    "dataset", "data_dir", "test_seq", "test_in_seq", "test_out_seq",
    "eval_batches", "batch_size", "quiet", "seed", "off_wandb",
    "fused_datagen", "use_mesh",
})


def _resurrect_train_config(cfg, saved: Dict) -> Config:
    """The saved train-time config, with the current block's evaluation
    protocol keys (and any key the saved one lacks)."""
    merged = dict(saved)
    for k, v in cfg.to_dict().items():
        if k in _TEST_PROTOCOL_KEYS or k not in merged:
            merged[k] = v
    return Config(merged)


def test(cfg, device: torch.device,
         logdir: Optional[pathlib.Path] = None) -> Dict:
    if cfg.model == "CATERClassifier":
        return eval_cater_classifier(cfg, device, logdir)
    ckpt = None
    if cfg.get("load_model", False):
        ckpt_id = cfg.get("ckpt_id")
        if not ckpt_id:
            raise ValueError(
                "phase=test with load_model=True requires an explicit "
                "ckpt_id (the tag the train run checkpointed under)")
        ckpt = CheckpointManager(
            find_checkpoint(cfg.get("logdir", "logs"), cfg.model, ckpt_id),
            tag=ckpt_id)
        saved_cfg = ckpt.load_config()
        if saved_cfg is not None:
            cfg = _resurrect_train_config(cfg, saved_cfg)

    run_id = resolve_run_id(cfg)
    logdir = (pathlib.Path(logdir or cfg.get("logdir", "logs")) / cfg.model
              / run_id)
    logger = MetricLogger(logdir, quiet=cfg.get("quiet", False))
    loaders, state = setup(cfg, device)
    if ckpt is not None:
        step = cfg.get("ckpt_step") or None
        step = int(step) if step else None
        if cfg.get("gan", False):
            # The generator's parameters and BatchNorm statistics.
            model = state.model
            restored = ckpt.restore(
                {"gen_params": dict(model.named_parameters()),
                 "gen_model_state": dict(model.named_buffers())},
                step=step, allow_missing=("gen_model_state",))
            model.load_state_dict({**restored["state"]["gen_params"],
                                   **restored["state"]["gen_model_state"]})
        else:
            restored = ckpt.restore(_snapshot(state), step=step)
            _load(state, restored["state"])
        print(f"loaded checkpoint {ckpt.tag} step {restored['step']} "
              f"from {ckpt.directory}")

    eval_step = make_eval_step()
    sample_gen = _sample_generator(cfg, device)
    loader = loaders["test_dataloader"]
    batches = int(cfg.get("eval_batches", 0)) or loaders["n_test_batches"]
    lpips_fn = lpips_horizon_fn(cfg, device)
    all_metrics = []
    for _ in range(batches):
        batch = make_batch_dict(next(loader), n_in=cfg.test_in_seq,
                                with_flow_labels=needs_flow_labels(cfg))
        metrics, pred = eval_step(state.model, batch, sample_gen)
        if cfg.get("debug_nans", False):
            check_finite("test batch", {"prediction": pred, **metrics})
        host = {k: v.cpu().numpy() for k, v in metrics.items()
                if not k.startswith("aux_")}
        gt = batch["data_to_predict"] + 0.5
        if lpips_fn is not None and pred.shape[:2] == gt.shape[:2]:
            host[lpips_fn.metric_key] = lpips_fn(pred, gt).cpu().numpy()
        all_metrics.append(host)

    # Mean over batches -> per-horizon curves; the last horizon is the
    # final metric.
    stacked = {k: np.mean(np.stack([m[k] for m in all_metrics]), axis=0)
               for k in all_metrics[0]}
    final = {f"final_{k}": float(v[-1]) for k, v in stacked.items()}
    per_horizon = {k: v.tolist() for k, v in stacked.items()}
    logger.log(0, final)
    (logdir / "per_horizon.json").write_text(json.dumps(per_horizon))
    # The last batch's first video: ground truth over prediction (the
    # observed frames lead both where the model predicts them too).
    gt, pr = _host(batch["data_to_predict"][0]) + 0.5, _host(pred[0])
    if pr.shape[0] != gt.shape[0]:
        gt = np.concatenate([_host(batch["observed_data"][0]) + 0.5, gt])
    save_filmstrip(logdir / "pred_gt.png", [gt, pr])
    logger.close()
    return {**final, "per_horizon": per_horizon}
