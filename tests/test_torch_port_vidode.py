"""Vid-ODE in the port against the JAX package: the z0 encoder's mask,
``SoftPositionEmbed``, the model (len20, irregular with a mask, slots
with ``slot_noise`` given, and ``mem`` with nru and nru2), the warp's
border, and the registry's models for all ten Vid-ODE train blocks.
Helpers and sizes the other Vid-ODE test files share live here.

The model runs narrowed (base_ch 8, n_downs 2, 32x32 frames, batch 2,
3 -> 3 frames, 2 ODE layers; slots: 3 slots of 8 channels), the port
loaded with JAX's init (params and batch_stats, ``convert.py``,
``strict=True``). Tolerances, as tests/test_torch_port_s3vae.py:
prediction 1e-4 max abs, loss and its terms 1e-5 relative, the BatchNorm
buffers after the step 1e-5 relative L2, equal NFE, and every gradient
leaf within 1e-3 of its norm plus 1e-5 of the whole gradient's norm,
against JAX's gradients in fp64 (the model cloned with fp64 compute and
parameters under ``jax.enable_x64``): BatchNorm in training makes fp32
gradients ill-conditioned (tests/test_torch_port_s3vae.py prints the
readings). Here the port's fp32 gradients lie within 0.003 of that
bound from JAX's fp64 ones, and within 0.05 of it from JAX's fp32 ones,
on a CPU.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import max_abs, net_parity, np32, t32
from test_torch_port_s3vae import (JaxGradsF64, assert_buffers_close,
                                   assert_grads_match, load_port)
from ode_rl_torch.core.config import load_config
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.models.registry import build_model
from ode_rl_torch.models.vidode import VidODEModel
from ode_rl_torch.nn.odeconvgru import ODEConvGRUEncoder
from ode_rl_torch.nn.slot_attention import SoftPositionEmbed

B, T_IN, SIZE = 2, 3, 32
OUT_TOL, LOSS_TOL = 1e-4, 1e-5
SMALL = dict(in_channels=1, n_downs=2, base_ch=8, n_layers=2)
SLOTS = dict(slot_attention=True, num_slots=3, slot_dim=8)
# Irregular observations: each video misses one of its three frames.
MASK = np.array([[1.0, 0.0, 1.0], [1.0, 1.0, 0.0]], np.float32)
METRICS = {"loss", "recon_l1", "diff_l1", "nfe", "ode_converged"}

VIDODE_BLOCKS = (
    "train_mmnist_vidode_len20", "train_mmnist_vidode_irregular",
    "train_mmnist_vidode_gan", "train_mmnist_vidode_slots",
    "train_kth_vidode", "train_mgif_vidode", "train_penn_vidode",
    "train_hurricane_vidode", "train_phyre_vidode", "train_minerl_vidode")


def video(seed: int = 0, b: int = B, t: int = 2 * T_IN, size: int = SIZE,
          c: int = 1) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return (rng.rand(b, t, size, size, c) - 0.5).astype(np.float32)


def batches(v: np.ndarray, mask=None, slot_noise=None):
    """The same batch for JAX and for the port."""
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch

    jb = dict(jax_batch(jnp.asarray(v), n_in=T_IN))
    pb = make_batch_dict(t32(v), T_IN)
    for key, value in (("observed_mask", mask), ("slot_noise", slot_noise)):
        if value is not None:
            jb[key], pb[key] = jnp.asarray(value), t32(value)
    return jb, pb


def jax_model(**kw):
    from ode_rl_tpu.models.vidode import VidODEModel as JaxVidODE
    return JaxVidODE(**{**SMALL, **kw})


def port_model(**kw) -> VidODEModel:
    return VidODEModel(**{**SMALL, **kw},
                       generator=torch.Generator().manual_seed(0))


def jax_init(model, jb) -> dict:
    return dict(jax.jit(lambda b: model.init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)}, b,
        train=True, method=model.loss))(jb))


def jax_loss(model, variables, jb, train: bool = True):
    """(loss, metrics, prediction, new state, fp32 grads) of JAX's loss."""
    state = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p):
        (loss, (metrics, pred)), new_state = model.apply(
            {"params": p, **state}, jb, train=train, method=model.loss,
            mutable=list(state), rngs={"sample": jax.random.key(3)})
        return loss, (metrics, pred, new_state)

    (loss, (metrics, pred, new_state)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return loss, metrics, pred, new_state, grads


def assert_metrics_close(metrics, j_metrics) -> None:
    assert set(metrics) == set(j_metrics) == METRICS
    for k in ("loss", "recon_l1", "diff_l1"):
        ref = float(j_metrics[k])
        assert abs(float(metrics[k]) - ref) <= LOSS_TOL * abs(ref), k
    for k in ("nfe", "ode_converged"):
        assert int(metrics[k]) == int(j_metrics[k]), k


def model_parity(mask=None, slot_noise=None, c: int = 1, **kw):
    """One training-mode loss and its gradients through both models from
    JAX's init on ``c``-channel videos: prediction, loss terms, NFE,
    BatchNorm buffers, and the gradients against JAX's in fp64. Returns
    the port's model."""
    jb, pb = batches(video(c=c), mask, slot_noise)
    kw = {**kw, "in_channels": c}
    model = jax_model(**kw)
    variables = jax_init(model, jb)
    _, j_metrics, j_pred, j_state, _ = jax_loss(model, variables, jb)
    port = port_model(**kw)
    load_port(port, variables)
    port.train()
    loss, (metrics, pred) = port.loss(pb)
    loss.backward()
    metrics = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
    assert pred.shape == j_pred.shape == (B, T_IN, SIZE, SIZE, c)
    assert max_abs(pred, j_pred) <= OUT_TOL
    assert_metrics_close(metrics, j_metrics)
    assert_buffers_close(port, j_state["batch_stats"])
    assert_grads_match(port, JaxGradsF64(model, True)(variables, jb))
    return port


# ------------------------------ the encoder -------------------------------

class _JaxEncoder(fnn.Module):
    """JAX's encoder with the port's outputs (mu, |std|)."""
    hoist: bool = False

    @fnn.compact
    def __call__(self, xs, ts, mask=None):
        from ode_rl_tpu.nn.odeconvgru import ODEConvGRUEncoder as Enc
        return Enc(ch=16, ode_n_layers=2, ode_n_units=16,
                   hoist_projections=self.hoist, name="enc")(
            xs, ts, mask=mask)[:2]


class _PortEncoder(torch.nn.Module):
    def __init__(self, hoist: bool):
        super().__init__()
        self.enc = ODEConvGRUEncoder(16, ode_n_layers=2, ode_n_units=16,
                                     hoist_projections=hoist,
                                     generator=torch.Generator().manual_seed(0))

    def forward(self, xs, ts, mask=None):
        return self.enc(xs, ts, mask=mask)


@pytest.mark.parametrize("hoist", [False, True], ids=["plain", "hoisted"])
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_encoder_mask_matches_jax(hoist, masked):
    """(mu, std) and every parameter's gradient against the JAX encoder,
    with and without a (B, T) mask, on both loops: outputs 1e-5 relative
    L2, gradients 1e-4 (tests/test_torch_port_modules.py's bounds). A
    masked step keeps the Euler step's state, so the masked result
    differs from the unmasked one."""
    rng = np.random.RandomState(4)
    xs = rng.randn(B, 4, 8, 8, 16).astype(np.float32)
    ts = np.arange(4, dtype=np.float32) / 8.0
    inputs = [xs, ts]
    if masked:
        inputs.append(np.array([[1, 0, 1, 1], [0, 1, 1, 0]], np.float32))
    net_parity(_JaxEncoder(hoist=hoist), _PortEncoder(hoist), inputs,
               out_tol=1e-5, grad_tol=1e-4)


def test_encoder_without_mask_is_unchanged():
    """No mask runs no gating: bit-equal to an all-ones mask, and on the
    hoisted loop within 1e-5 of the plain one."""
    rng = np.random.RandomState(5)
    xs, ts = t32(rng.randn(B, 4, 8, 8, 16)), t32(np.arange(4) / 8.0)
    plain, hoisted = _PortEncoder(False), _PortEncoder(True)
    hoisted.load_state_dict(plain.state_dict())
    with torch.no_grad():
        mu, std = plain(xs, ts)
        mu1, std1 = plain(xs, ts, torch.ones(B, 4))
        mu_h, _ = hoisted(xs, ts)
        mu_m, _ = plain(xs, ts, t32([[1, 0, 1, 1], [1, 1, 1, 1]]))
    assert torch.equal(mu, mu1) and torch.equal(std, std1)
    assert max_abs(mu_h, mu) <= 1e-5
    assert torch.equal(mu_m[1], mu[1]) and max_abs(mu_m[0], mu[0]) > 1e-3


# --------------------------- SoftPositionEmbed -----------------------------

def test_soft_position_embed_matches_jax():
    """x + Dense(grid) on a non-square map: 1e-6 max abs (the grids are
    within an fp32 ulp of each other), gradients 1e-5 relative L2."""
    from ode_rl_tpu.nn.slot_attention import SoftPositionEmbed as JaxSPE

    x = np.random.RandomState(6).randn(3, 5, 7, 12).astype(np.float32)
    net_parity(JaxSPE(hidden_size=12),
               SoftPositionEmbed(12, generator=torch.Generator()),
               [x], out_metric=max_abs, out_tol=1e-6, grad_tol=1e-5)


# ------------------------------- the model --------------------------------

def test_len20_matches_jax():
    """The regular batch (all-ones observed mask, as JAX's batches carry
    it)."""
    port = model_parity()
    names = {n for n, _ in port.named_parameters()}
    assert "encoder_z0.step.cgru_cell.conv_gates.weight" in names
    assert "ode_decoder_func.mid_1.kernel" in names
    assert port.conv_decoder.conv_out.weight.shape[0] == 1 + 3
    assert port.encoder_z0.step.cgru_cell.groups_g == 2 * 32 // 32


@pytest.mark.parametrize("c", [3, 6])
def test_corpus_channels_match_jax(c):
    """The corpora's RGB (mgif, penn, phyre, minerl) and hurricane's six
    fields: the encoder takes ``c`` channels, and the decoder emits the
    frame's ``c``, the flow's 2 and the mask's 1."""
    port = model_parity(c=c)
    assert port.conv_encoder.conv_in.weight.shape[1] == c
    assert port.conv_decoder.conv_out.weight.shape[0] == c + 3


def test_irregular_mask_matches_jax():
    model_parity(mask=MASK)


def test_slots_match_jax():
    """The slot variant with ``slot_noise`` given (no draw) and a mask:
    the slot module keeps flax's name, its MLP is ``slot_dim`` wide, the
    decoder emits flow, frame, mask and alpha."""
    noise = np.random.RandomState(7).randn(B, 3, 8).astype(np.float32)
    port = model_parity(mask=MASK, slot_noise=noise, **SLOTS)
    assert port.slot_attention.mlp_0.kernel.shape == (8, 8)
    assert "encoder_pos.dense.kernel" in {n for n, _ in
                                          port.named_parameters()}
    assert port.conv_decoder.conv_out.weight.shape[0] == 1 + 4


@pytest.mark.parametrize("mem_mode", ["nru", "nru2"])
def test_mem_matches_jax(mem_mode):
    model_parity(mem=True, mem_mode=mem_mode)


def test_slot_noise_is_one_draw_a_video():
    """Without ``slot_noise`` the port draws one (B, S, slot_dim) normal
    from the generator, shared by the video's frames: the same generator
    state gives the same prediction as that draw passed in."""
    _, pb = batches(video())
    port = port_model(**SLOTS).eval()
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        drawn, _ = port.predict(pb, gen)
        noise = torch.randn((B, 3, 8),
                            generator=torch.Generator().manual_seed(11))
        given, _ = port.predict({**pb, "slot_noise": noise})
    assert torch.equal(drawn, given)
    with pytest.raises(ValueError, match="generator"):
        port.predict(pb)


def test_eval_mode_uses_running_statistics():
    """In eval mode BatchNorm reads its buffers and leaves them: the
    prediction against JAX's ``train=False`` one, 1e-4 max abs."""
    jb, pb = batches(video(1))
    model = jax_model()
    variables = jax_init(model, jb)
    _, _, _, j_state, _ = jax_loss(model, variables, jb)
    variables = {**variables, **j_state}
    j_pred, _ = jax.jit(lambda b: model.apply(
        variables, b, train=False, method=model.predict))(jb)
    port = port_model()
    load_port(port, variables)
    before = {n: b.clone() for n, b in port.named_buffers()}
    port.eval()
    with torch.no_grad():
        pred, _ = port.predict(pb)
    assert max_abs(pred, j_pred) <= OUT_TOL
    assert all(torch.equal(b, before[n]) for n, b in port.named_buffers())


# ------------------------------ the warp edge ------------------------------

def test_warp_border_gradient_convention():
    """A sample exactly on the image's left edge (ix = 0): JAX's clip
    passes half the flow's gradient there and torch's grid_sample none;
    one pixel inside, both pass all of it. (At the right edge the
    bilinear's second tap clamps onto the first, and both pass none.) The model's outer ring (base grid +-1, half a
    pixel outside under align_corners=False) clamps on both sides, and a
    random flow puts no sample exactly on the edge, so the model tests
    above hold the flow's gradient in full."""
    from ode_rl_tpu.ops.warp import grid_sample as jax_grid_sample
    from ode_rl_torch.ops.warp import grid_sample

    rng = np.random.RandomState(8)
    img = rng.rand(1, 8, 8, 1).astype(np.float32)
    # gx for ix = 0 (the edge) and ix = 1 (inside), exact in fp32 at
    # W = 8: ix = ((gx + 1) * W - 1) / 2.
    gxs = np.array([-0.875, -0.625], np.float32)
    grid = np.zeros((1, 1, 2, 2), np.float32)
    grid[0, 0, :, 0] = gxs
    grid[0, 0, :, 1] = 0.1

    jg = np.asarray(jax.grad(lambda g: jnp.sum(jax_grid_sample(
        jnp.asarray(img), g)))(jnp.asarray(grid)))
    tg = t32(grid).requires_grad_(True)
    grid_sample(t32(img), tg).sum().backward()
    tg = np32(tg.grad)
    assert abs(tg[0, 0, 1, 0] - jg[0, 0, 1, 0]) <= 1e-5 * abs(jg[0, 0, 1, 0])
    assert tg[0, 0, 0, 0] == 0.0
    assert abs(jg[0, 0, 0, 0]) > 0.0
    # JAX's is half of the one-sided slope into the image.
    slope = np.asarray(jax.grad(lambda g: jnp.sum(jax_grid_sample(
        jnp.asarray(img), g)))(jnp.asarray(grid) + np.array(
            [[[[1e-3, 0.0], [0.0, 0.0]]]], np.float32)))[0, 0, 0, 0]
    assert abs(jg[0, 0, 0, 0] - 0.5 * slope) <= 1e-3 * abs(slope)


# ------------------------------ the registry ------------------------------

@pytest.mark.parametrize("block", VIDODE_BLOCKS)
def test_registry_builds_every_vidode_block(block):
    """Both registries at the block's full widths: the port takes JAX's
    parameter and batch_stats tree (shapes only, zeros) with
    ``strict=True``."""
    from ode_rl_tpu.core.config import load_config as jax_load
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    from ode_rl_tpu.models.registry import build_model as jax_build
    from ode_rl_torch.convert import flax_to_torch

    jcfg = jax_load(["defaults", block])
    cfg = load_config(["defaults", block])
    size = 64 if cfg.dataset in ("mmnist", "kth", "phyre", "minerl",
                                 "hurricane") else 128
    v = jnp.zeros((1, 4, size, size, cfg.in_channels))
    jb = dict(jax_batch(v, n_in=2))
    if cfg.get("slot_attention", False):
        jb["slot_noise"] = jnp.zeros((1, cfg.num_slots, cfg.slot_dim))
    model = jax_build(jcfg)
    shapes = jax.eval_shape(lambda b: model.init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)}, b,
        train=True, method=model.loss), jb)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    port = build_model(cfg, torch.device("cpu"),
                       torch.Generator().manual_seed(0))
    port.load_state_dict(flax_to_torch(zeros["params"],
                                       zeros["batch_stats"]), strict=True)
    assert port.slots == bool(cfg.get("slot_attention", False))
    assert port.conv_encoder.conv_in.weight.shape[1] == cfg.in_channels
