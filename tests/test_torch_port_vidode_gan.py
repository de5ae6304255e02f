"""Vid-ODE's GAN loop, LPIPS and PNG writer in the port against the JAX
package: ``PatchDiscriminator`` and its instance norm, the LSGAN losses,
the sequence rearrangements, the learning-rate staircase, one GAN train
step (extrapolation and interpolation) against JAX's
``make_gan_train_step``, LPIPS (random and loaded weights, the test
phase's per-horizon function and its metric key), and the PNG sheets
decoded with ``zlib``.

The GAN step starts both sides from JAX's state (the generator's params
and batch_stats and both discriminators, ``convert.py``) on the narrowed
model of tests/test_torch_port_vidode.py, ``lamb_adv`` 0.5 so that the
adversarial terms weigh in the generator's gradient. Adamax's first
update is lr * g / (|g| + eps), about lr * sign(g), so an element whose
gradient is rounding (the conv biases before a BatchNorm or an instance
norm: zero in exact arithmetic) moves by +-lr on either side at random;
the step's gradients are compared instead: JAX's, read from its
optimizers' first moments (mu = 0.1 g after one step), against the
port's, in fp64 on both sides (the test says why), and the port's
update is checked to be its Adamax step at the schedule's rate. Losses
1e-5 relative; BatchNorm buffers 1e-5 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from torch_port_util import decode_png, max_abs, np32, rel_l2, t32
from test_torch_port_s3vae import (assert_buffers_close, assert_grads_match,
                                   f64_batch, load_port, port_f64)
from test_torch_port_vidode import (T_IN, batches, jax_model, port_model,
                                    video)
from ode_rl_torch.convert import flax_to_torch
from ode_rl_torch.core.config import Config
from ode_rl_torch.eval_models.lpips import (ALEX_PLAN, LPIPS,
                                            load_torch_weights,
                                            lpips_distance, lpips_horizon_fn)
from ode_rl_torch.nn import discriminators as disc
from ode_rl_torch.train.gan import (GANState, make_gan_lr_schedule,
                                    make_gan_train_step)
from ode_rl_torch.train.visualize import dump_pred_gt_pngs, save_filmstrip

LOSS_TOL, BN_TOL = 1e-5, 1e-5
F64_RTOL, F64_ATOL = 1e-5, 1e-8


# ---------------------------- discriminators ------------------------------

def test_patch_discriminator_matches_jax():
    """Logits 1e-5 relative L2; the gradients of sum(logits * w) within
    1e-3 of each leaf's norm plus 1e-5 of the whole norm: the biases of
    l2-l4 feed an instance norm, so their gradient is zero in exact
    arithmetic and rounding on both sides (JAX's reads 1.3 of its own
    norm away from the port's at this input)."""
    from ode_rl_tpu.nn.discriminators import PatchDiscriminator as JaxD

    rng = np.random.RandomState(0)
    x = rng.rand(2, 32, 32, 5).astype(np.float32)
    jd = JaxD()
    variables = jd.init(jax.random.key(0), jnp.asarray(x))
    out = jd.apply(variables, jnp.asarray(x))
    w = rng.randn(*out.shape).astype(np.float32)
    grads = jax.grad(lambda p: jnp.sum(jd.apply({"params": p},
                                                jnp.asarray(x)) * w))(
        variables["params"])
    port = disc.PatchDiscriminator(5, generator=torch.Generator())
    port.load_state_dict(flax_to_torch(jax.tree_util.tree_map(
        np.asarray, variables["params"])), strict=True)
    ours = port(t32(x))
    assert ours.shape == out.shape and rel_l2(ours, out) <= 1e-5
    torch.sum(ours * t32(w)).backward()
    assert_grads_match(port, flax_to_torch(jax.tree_util.tree_map(
        np.asarray, grads)))


def test_instance_norm_matches_jax_and_torch():
    """JAX's ``_instance_norm`` (biased variance, eps 1e-5, no affine) and
    ``F.instance_norm`` on NCHW: both within 1e-5 max abs of the port's,
    here on maps whose mean is far from zero."""
    from ode_rl_tpu.nn.discriminators import _instance_norm

    x = (3.0 + np.random.RandomState(1).randn(2, 6, 5, 4)).astype(
        np.float32)
    ours = disc.instance_norm(t32(x))
    assert max_abs(ours, _instance_norm(jnp.asarray(x))) <= 1e-5
    lib = torch.nn.functional.instance_norm(t32(x).permute(0, 3, 1, 2),
                                            eps=1e-5).permute(0, 2, 3, 1)
    assert max_abs(ours, lib) <= 1e-5


def test_lsgan_and_rearrangements_match_jax():
    """Losses 1e-6 relative; the windows equal (extrapolation with a
    context of 3 and of 1 frame, so one pads; interpolation)."""
    from ode_rl_tpu.nn import discriminators as jd

    rng = np.random.RandomState(2)
    a, b = rng.randn(3, 2, 2, 4), rng.randn(3, 2, 2, 4)
    assert abs(float(disc.lsgan_d_loss(t32(a), t32(b)))
               / float(jd.lsgan_d_loss(a, b)) - 1) <= 1e-6
    assert abs(float(disc.lsgan_g_loss(t32(b)))
               / float(jd.lsgan_g_loss(b)) - 1) <= 1e-6
    seq = rng.rand(2, 3, 4, 4, 2).astype(np.float32)
    for ctx_len in (3, 1):
        ctx = rng.rand(2, ctx_len, 4, 4, 2).astype(np.float32)
        ours = disc.rearrange_seq_extrap(t32(seq), t32(ctx))
        theirs = jd.rearrange_seq_extrap(jnp.asarray(seq), jnp.asarray(ctx))
        assert ours.shape[-1] == disc.seq_channels(ctx_len, 3, 2, True)
        assert np.array_equal(np32(ours), np.asarray(theirs))
    ctx = rng.rand(2, 3, 4, 4, 2).astype(np.float32)
    ours = disc.rearrange_seq_interp(t32(seq), t32(ctx))
    assert ours.shape[-1] == disc.seq_channels(3, 3, 2, False)
    assert np.array_equal(np32(ours), np.asarray(jd.rearrange_seq_interp(
        jnp.asarray(seq), jnp.asarray(ctx))))
    assert np.array_equal(np32(disc.frames_to_images(t32(seq))),
                          np.asarray(jd.frames_to_images(seq)))


def test_lr_staircase_matches_optax():
    """0.99 per epoch, stepped at epoch boundaries; constant without
    decay or without steps."""
    from ode_rl_tpu.train.gan import make_gan_lr_schedule as jax_schedule

    cfg = Config({"lr": 1e-3, "lr_decay": 0.99})
    ours, theirs = make_gan_lr_schedule(cfg, 3), jax_schedule(cfg, 3)
    for step in range(10):
        assert abs(ours(step) / float(theirs(step)) - 1) <= 1e-6, step
    assert ours(2) == 1e-3 and ours(3) == 1e-3 * 0.99
    flat = Config({"lr": 1e-3, "lr_decay": 1.0})
    assert make_gan_lr_schedule(flat, 3)(9) == 1e-3
    assert make_gan_lr_schedule(cfg, 0)(9) == 1e-3


# ------------------------------ the GAN step ------------------------------

def _adamax_grads(opt_state) -> dict:
    """The gradient of a first optax.adamax step from its mu = 0.1 g."""
    mu = opt_state[0].mu
    return flax_to_torch(jax.tree_util.tree_map(
        lambda m: np.asarray(m, np.float64) / 0.1, mu))


def _jax_gan_step(model, host, jb, extrap, dtype):
    """JAX's GAN step from the given (params, model state, disc params),
    every tree and the compute in ``dtype``: (new state, metrics)."""
    import optax
    from ode_rl_tpu.core.config import Config as JaxConfig
    from ode_rl_tpu.train.gan import GANTrainState
    from ode_rl_tpu.train.gan import make_gan_lr_schedule as jax_schedule
    from ode_rl_tpu.train.gan import make_gan_train_step as jax_step

    schedule = jax_schedule(JaxConfig(ENTRIES), 2)
    cast = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype), t)
    gen_params, gen_state, disc_params = (cast(t) for t in host)
    tx = optax.adamax(schedule)
    state = GANTrainState(
        step=jnp.asarray(0, jnp.int32), gen_params=gen_params,
        gen_model_state=gen_state, disc_params=disc_params,
        gen_opt_state=tx.init(gen_params),
        disc_opt_state=tx.init(disc_params), gen_tx=tx, disc_tx=tx)
    model = model.clone(dtype=dtype, param_dtype=dtype)
    step = jax_step(model, extrap=extrap, lamb_adv=0.5,
                    lr_schedule=schedule, disc_dtype=dtype)
    return step(state, cast(jb), jax.random.key(1))


def _port_gan_state(host, extrap, f64=False) -> GANState:
    gen = port_model()
    load_port(gen, {"params": host[0], **host[1]})
    g = torch.Generator().manual_seed(0)
    d = nn.ModuleDict({
        "image": disc.PatchDiscriminator(1, generator=g),
        "seq": disc.PatchDiscriminator(
            disc.seq_channels(T_IN, T_IN, 1, extrap), generator=g)})
    d.load_state_dict(flax_to_torch(host[2]), strict=True)
    if f64:
        gen, d = port_f64(gen), port_f64(d)
    return GANState(gen, d, make_gan_lr_schedule(Config(ENTRIES), 2))


ENTRIES = {"lr": 1e-3, "lr_decay": 0.99}


@pytest.mark.parametrize("extrap", [True, False], ids=["extrap", "interp"])
def test_gan_step_matches_jax(extrap):
    """In fp32, the metrics, the BatchNorm buffers after the step (G's
    forward's, on both sides) and the port's Adamax update at lr(0). The
    gradients of both updates, D's and G's, in fp64 on both sides (the
    port's state copied to fp64, JAX's step with fp64 trees and compute)
    to 1e-5 relative L2 plus 1e-8 of the whole norm. In fp32 G's gradient
    is ill-conditioned at this state: the discriminators' gradient with
    respect to the prediction moves 1.5e-3 relative when the prediction
    moves by its fp32 rounding (2.6e-6), so the port's fp32 gradient of
    the ConvGRU's candidate conv lies 2.2 of the bound above from fp64,
    JAX's 0.03 on a CPU; neither is the other's reference)."""
    from ode_rl_tpu.core.config import Config as JaxConfig
    from ode_rl_tpu.train.gan import create_gan_state

    jb, pb = batches(video(3))
    model = jax_model()
    init = create_gan_state(model, JaxConfig(ENTRIES), jb,
                            jax.random.key(0), steps_per_epoch=2,
                            extrap=extrap)
    host = jax.tree_util.tree_map(np.asarray, (
        init.gen_params, init.gen_model_state, init.disc_params))
    new, j_metrics = _jax_gan_step(model, host, jb, extrap, jnp.float32)

    ours = _port_gan_state(host, extrap)
    gen = ours.gen
    before = {n: p.detach().clone() for n, p in gen.named_parameters()}
    metrics = make_gan_train_step(extrap=extrap, lamb_adv=0.5)(ours, pb)
    assert set(metrics) == set(j_metrics)
    for k in ("loss", "recon_l1", "diff_l1", "g_adv_loss", "recon_total",
              "d_loss", "g_loss", "lr"):
        ref = float(j_metrics[k])
        assert abs(float(metrics[k]) - ref) <= LOSS_TOL * abs(ref), k
    assert int(metrics["nfe"]) == int(j_metrics["nfe"])
    assert ours.step == 1
    assert_buffers_close(gen, new.gen_model_state["batch_stats"], BN_TOL)
    # The port's update is its Adamax step at lr(0): within 1e-5 of lr
    # plus the parameters' fp32 rounding.
    for n, p in gen.named_parameters():
        expect = before[n] - 1e-3 * p.grad / (p.grad.abs() + 1e-8)
        err = (p.detach() - expect).abs()
        assert torch.all(err <= 1e-8 + 2.5e-7 * before[n].abs()), n

    with jax.enable_x64(True):
        new64, _ = _jax_gan_step(model, host, jb, extrap, jnp.float64)
        g_ref, d_ref = (_adamax_grads(new64.gen_opt_state),
                        _adamax_grads(new64.disc_opt_state))
    ours64 = _port_gan_state(host, extrap, f64=True)
    make_gan_train_step(extrap=extrap, lamb_adv=0.5)(ours64, f64_batch(pb))
    assert_grads_match(ours64.gen, g_ref, F64_RTOL, F64_ATOL)
    assert_grads_match(ours64.disc, d_ref, F64_RTOL, F64_ATOL)


def test_gan_lr_reaches_the_optimizers():
    """Two steps with one step an epoch: the second runs at lr * 0.99,
    in the metric and in both optimizers."""
    _, pb = batches(video(4))
    g = torch.Generator().manual_seed(0)
    d = nn.ModuleDict({"image": disc.PatchDiscriminator(1, generator=g),
                       "seq": disc.PatchDiscriminator(
                           disc.seq_channels(T_IN, T_IN, 1, True),
                           generator=g)})
    state = GANState(port_model(), d,
                     make_gan_lr_schedule(Config({"lr": 2e-3}), 1))
    step = make_gan_train_step()
    lrs = [step(state, pb)["lr"] for _ in range(2)]
    assert lrs == [2e-3, 2e-3 * 0.99]
    for opt in (state.gen_opt, state.disc_opt):
        assert opt.param_groups[0]["lr"] == 2e-3 * 0.99


# --------------------------------- LPIPS ----------------------------------

def _npz_weights(tmp_path):
    """Converted-AlexNet and lin weights of torchvision's shapes."""
    rng = np.random.RandomState(3)
    alex, lins, cin = {}, {}, 3
    for i, (f, k, _, _) in enumerate(ALEX_PLAN):
        alex[f"conv{i}_w"] = (0.05 * rng.randn(f, cin, k, k)).astype(
            np.float32)
        alex[f"conv{i}_b"] = (0.05 * rng.randn(f)).astype(np.float32)
        lins[f"lin{i}"] = rng.rand(1, f, 1, 1).astype(np.float32)
        cin = f
    np.savez(tmp_path / "alex.npz", **alex)
    np.savez(tmp_path / "lins.npz", **lins)
    return tmp_path / "alex.npz", tmp_path / "lins.npz"


def test_lpips_matches_jax(tmp_path):
    """JAX's random init converted, then weights loaded from .npz on both
    sides: scores 1e-5 relative at 64x64 and 32x32."""
    from ode_rl_tpu.eval_models import lpips as jl

    rng = np.random.RandomState(4)
    variables = jl.init_lpips()
    alex, lins = _npz_weights(tmp_path)
    loaded = jl.load_torch_weights(variables, str(alex), str(lins))
    ports = []
    for calibrated in (False, True):
        port = LPIPS(generator=torch.Generator())
        port.load_state_dict(flax_to_torch(jax.tree_util.tree_map(
            np.asarray, variables["params"])), strict=True)
        ports.append(load_torch_weights(port, alex, lins) if calibrated
                     else port)
    for size in (64, 32):
        a, b = (rng.rand(2, size, size, 3).astype(np.float32)
                for _ in range(2))
        for port, vs, calibrated in ((ports[0], variables, False),
                                     (ports[1], loaded, True)):
            ours = lpips_distance(port, t32(a), t32(b), calibrated)
            theirs = jl.lpips_distance(vs, jnp.asarray(a), jnp.asarray(b),
                                       calibrated=calibrated)
            assert rel_l2(ours, theirs) <= 1e-5, (size, calibrated)


def test_lpips_horizon_and_metric_key(tmp_path):
    """The test phase's per-horizon LPIPS: ``lpips_uncalibrated`` without
    weights, ``lpips`` with them and then (T,) values 1e-5 relative to
    JAX's on grayscale frames; a named file that is missing raises; off
    for other models under ``auto``."""
    from ode_rl_tpu.core.config import Config as JaxConfig
    from ode_rl_tpu.train.loop import _make_lpips_horizon_fn

    cpu = torch.device("cpu")
    fn = lpips_horizon_fn(Config({"model": "VidODE", "eval_lpips": "auto"}),
                          cpu)
    assert fn.metric_key == "lpips_uncalibrated"
    assert lpips_horizon_fn(Config({"model": "ODEConv"}), cpu) is None
    alex, lins = _npz_weights(tmp_path)
    entries = {"model": "VidODE", "eval_lpips": "auto",
               "lpips_alexnet_npz": str(alex), "lpips_lins_npz": str(lins)}
    fn = lpips_horizon_fn(Config(entries), cpu)
    theirs_fn = _make_lpips_horizon_fn(JaxConfig(entries))
    assert fn.metric_key == theirs_fn.metric_key == "lpips"
    rng = np.random.RandomState(5)
    pred, gt = (rng.rand(2, 3, 32, 32, 1).astype(np.float32) * 1.2 - 0.1
                for _ in range(2))
    ours = fn(t32(pred), t32(gt))
    assert ours.shape == (3,)
    assert rel_l2(ours, theirs_fn(jnp.asarray(pred), jnp.asarray(gt))) <= 1e-5
    with pytest.raises(FileNotFoundError, match="lpips_alexnet_npz"):
        lpips_horizon_fn(Config({**entries, "lpips_alexnet_npz": str(
            tmp_path / "missing.npz")}), cpu)


# ---------------------------------- PNG -----------------------------------

def test_png_sheets_decode_to_the_frames(tmp_path):
    """A filmstrip of two videos and the per-frame dump decode (zlib) to
    JAX's uint8 conversion of the frames; PIL reads them alike."""
    from ode_rl_tpu.train.visualize import _to_uint8

    rng = np.random.RandomState(6)
    gt = rng.rand(3, 4, 5, 1).astype(np.float32) * 1.4 - 0.2
    pred = rng.rand(3, 4, 5, 1).astype(np.float32)
    path = save_filmstrip(tmp_path / "sheet" / "s.png", [gt, pred])
    sheet = decode_png(path)
    expect = np.concatenate([np.concatenate(list(_to_uint8(v)), axis=1)
                             for v in (gt, pred)], axis=0)
    assert sheet.shape == (8, 15, 3) and np.array_equal(sheet, expect)
    from PIL import Image
    assert np.array_equal(np.asarray(Image.open(path).convert("RGB")),
                          expect)

    videos = rng.rand(2, 3, 4, 5, 3).astype(np.float32)
    n = dump_pred_gt_pngs(tmp_path / "dump", videos, videos[::-1])
    assert n == 12 and len(list((tmp_path / "dump").glob("*.png"))) == 12
    assert np.array_equal(decode_png(tmp_path / "dump" / "gt_0_2.png"),
                          _to_uint8(videos[1, 2]))
    # Hurricane's six channels: the first three.
    six = rng.rand(1, 2, 4, 4, 6).astype(np.float32)
    dump_pred_gt_pngs(tmp_path / "six", six, six)
    assert np.array_equal(decode_png(tmp_path / "six" / "pred_0_1.png"),
                          _to_uint8(six[0, 1, ..., :3]))
