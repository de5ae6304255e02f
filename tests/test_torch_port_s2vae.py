"""S2VAE, CS2VAE and DS2VAE in the port against the JAX package.

Each model is built by both registries from its ``configs.yaml`` block,
narrowed (B=2; d_zf 16, 2 slots; slot_size 8, or 32 for CS2VAE so that
its ConvGRU's gates take 2 groups; n_hid 24 for DS2VAE's RIM; 64x64
frames, which the C3D plans need: 12 observed frames for the 'default'
plan, which takes 10 from time, 20 for the 'cgru' plan; 3 predicted).
The port is loaded with JAX's init (params and batch_stats, converted by
``convert.py`` with the port's module: the per-slot stacks of
``slot_rollout`` split among the slots; ``strict=True``) and draws JAX's
noise: JAX's ``jax.random.normal`` is replaced inside the test by a
recorder (tests/test_torch_port_s3vae.py) that makes each of the
model's draws from a seeded numpy generator, and the port's ``Noise``
replays them in order. Nothing in ``ode_rl_tpu/`` changes.

Tolerances, in fp32 as the S3VAE tests: prediction 1e-4 max abs, loss
and each metric 1e-5 relative (relative to at least 1e-2), BatchNorm
buffers after the training-mode loss 1e-5 relative L2. The gradients are
ill-conditioned in fp32 (the decoder's training-mode BatchNorm: the
port's fp32 gradient of CS2VAE's ``cnn_decoder.conv_0`` lies 1.27e-3 of
its norm from JAX's fp64 one, past the 1e-3 the S3VAE tests allow), so
both sides compute them in fp64 (the model cloned with fp64 compute and
parameters, the same draws), and every leaf is held within 1e-6 of its
norm plus 1e-9 of the whole gradient's norm.

DS2VAE's RIM runs dropout (0.5) in training, whose masks cannot be
shared with JAX, so DS2VAE is held in eval mode (BatchNorm on its
running statistics, no dropout); CS2VAE with the inferred prior and the
masked decoder is held in eval mode too, the others in training mode.
The last test drives S2VAE through ``ode_rl_torch.main`` (train, resume,
test) on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import max_abs, t32
from test_torch_port_s3vae import (METRIC_FLOOR, Recorder, Replay,
                                   assert_buffers_close, assert_grads_match,
                                   f64_batch, port_f64, port_loss_and_grads)
from ode_rl_torch.convert import flax_to_torch
from ode_rl_torch.core.config import load_config
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.models.registry import build_model

B, N_OUT = 2, 3
OUT_TOL, LOSS_TOL = 1e-4, 1e-5
# Every gradient leaf, the port's fp64 against JAX's fp64: within this of
# its norm plus GRAD_ATOL of the whole gradient's norm.
GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-9


class SlotRecorder(Recorder):
    """The recorder of the S3VAE tests, for these models' files."""

    MODEL_FILES = ("models/s2vae.py", "models/ds2vae.py",
                   "nn/slot_attention.py", "sprite/dsvae.py")


def configs(block: str, n_in: int, **overrides):
    from ode_rl_tpu.core.config import load_config as jax_load
    ov = {"batch_size": B, "train_in_seq": n_in, "train_out_seq": N_OUT,
          "d_zf": 16, "num_slots": 2, "slot_size": 8, **overrides}
    return (jax_load(["defaults", block], overrides=ov),
            load_config(["defaults", block], overrides=ov))


def video(n_frames: int, seed: int = 0, channels: int = 1) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return (rng.rand(B, n_frames, 64, 64, channels) - 0.5).astype(np.float32)


def load_port(port, variables) -> None:
    tree = jax.tree_util.tree_map(np.asarray, dict(variables))
    port.load_state_dict(flax_to_torch(tree["params"],
                                       tree.get("batch_stats"), module=port),
                         strict=True)


def _loss_fn(model, train: bool):
    def loss_fn(p, state, jb):
        (loss, (metrics, pred)), new_state = model.apply(
            {"params": p, **state}, jb, train=train, method=model.loss,
            mutable=list(state), rngs={"sample": jax.random.key(3),
                                       "dropout": jax.random.key(4)})
        return loss, (metrics, pred, new_state)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def jax_reference(model, jb, train: bool, recorder=SlotRecorder):
    """JAX's init, its fp32 loss, metrics, prediction and updated
    batch_stats with the recorder's draws (and the draws), and its
    gradients in fp64 with the same draws."""
    rngs = {"params": jax.random.key(0), "sample": jax.random.key(1),
            "dropout": jax.random.key(2)}
    variables = dict(jax.jit(lambda b: model.init(
        rngs, b, train=True, method=model.loss))(jb))
    state = {k: v for k, v in variables.items() if k != "params"}
    rec = recorder()
    with pytest.MonkeyPatch.context() as mp:
        rec.patch(mp)
        (_, (metrics, pred, new_state)), _ = _loss_fn(model, train)(
            variables["params"], state, jb)
    f64 = lambda t: jax.tree_util.tree_map(
        lambda a: (jnp.asarray(np.asarray(a), jnp.float64)
                   if np.asarray(a).dtype == np.float32 else a), t)
    model64 = model.clone(dtype=jnp.float64, param_dtype=jnp.float64)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        recorder().patch(mp)
        v = f64(variables)
        st = {k: x for k, x in v.items() if k != "params"}
        _, grads = _loss_fn(model64, train)(v["params"], st, f64(jb))
        grads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       grads)
    return variables, metrics, pred, new_state, grads, rec.draws


def model_parity(jcfg, cfg, v, n_in, train, metrics_expected):
    """One loss of the model both registries build from (jcfg, cfg) on
    video ``v``, JAX's noise replayed: prediction, metrics, BatchNorm
    buffers (in training) and gradients. Returns the port's model."""
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    from ode_rl_tpu.models.registry import build_model as jax_build

    jb = jax_batch(jnp.asarray(v), n_in=n_in)
    model = jax_build(jcfg)
    variables, j_metrics, j_pred, j_state, j_grads, draws = jax_reference(
        model, jb, train)
    port = build_model(cfg, torch.device("cpu"),
                       torch.Generator().manual_seed(0))
    load_port(port, variables)
    replay = Replay(draws)
    metrics, pred = port_loss_and_grads(port, make_batch_dict(t32(v), n_in),
                                        replay, train)
    assert not replay.draws, "draws left over"
    assert pred.shape == j_pred.shape
    assert max_abs(pred, j_pred) <= OUT_TOL
    assert set(metrics) == set(metrics_expected) == set(j_metrics)
    for k in metrics_expected:
        ref = float(j_metrics[k])
        err = abs(float(metrics[k]) - ref) / max(abs(ref), METRIC_FLOOR)
        assert err <= LOSS_TOL, (k, float(metrics[k]), ref)
    if train:
        assert_buffers_close(port, j_state["batch_stats"])
    # The gradients in fp64 on both sides, the same draws.
    port64 = port_f64(port)
    load_port(port64, variables)
    port64.double()
    port_loss_and_grads(port64, f64_batch(make_batch_dict(t32(v), n_in)),
                        Replay(draws), train)
    assert_grads_match(port64, flax_to_torch(j_grads, module=port64),
                       rtol=GRAD_RTOL, atol=GRAD_ATOL)
    return port


S2VAE_METRICS = ("loss", "vae_loss", "recon_loss", "kl_loss")

# (id, block, observed frames, overrides, train)
S2VAE_CASES = [
    ("s2vae_1layer", "train_mmnist_s2vae", 12, {}, True),
    ("s2vae_2layers_infer_masked", "train_mmnist_s2vae", 12,
     {"gru_layers": 2, "prior": "infer", "unmasked": False}, True),
    ("cs2vae", "train_mmnist_cs2vae", 20, {"slot_size": 32}, True),
    ("cs2vae_infer_masked", "train_mmnist_cs2vae", 20,
     {"slot_size": 32, "prior": "infer", "unmasked": False}, False),
]


@pytest.mark.parametrize("name,block,n_in,overrides,train", S2VAE_CASES,
                         ids=[c[0] for c in S2VAE_CASES])
def test_s2vae_matches_jax(name, block, n_in, overrides, train):
    jcfg, cfg = configs(block, n_in, **overrides)
    port = model_parity(jcfg, cfg, video(n_in + N_OUT), n_in, train,
                        S2VAE_METRICS)
    assert len(port.slot_rollout) == 2
    names = {n for n, _ in port.named_parameters()}
    if block == "train_mmnist_cs2vae":
        # The VALID transposed conv and the ConvGRU of each slot.
        assert port.slot_rollout[1].up.weight.shape == (32, 32, 4, 4)
        assert port.slot_rollout[0].trans.groups_g == 2
        assert port.cnn_decoder.deconv_in.weight.shape[2:] == (3, 3)
    else:
        layers = overrides.get("gru_layers", 1)
        assert f"slot_rollout.1.trans.l{layers - 1}.hn.bias" in names
        assert f"slot_rollout.1.trans.l{layers}.hn.bias" not in names
    assert ("prior_gru.cell.ir.kernel" in names) == (
        overrides.get("prior") == "infer")


def test_ds2vae_matches_jax():
    jcfg, cfg = configs("train_mmnist_ds2vae", 12, n_hid=[24])
    port = model_parity(jcfg, cfg, video(12 + N_OUT), 12, False,
                        ("loss", "recon_loss", "kl_zf", "kl_zt"))
    # The RIM's three blocks of 8 and the decoder over S f + f channels.
    assert port.dynamic_net.core_0.block_gru.w_h.shape == (3, 8, 24)
    assert port.cnn_decoder.deconv_in.weight.shape[0] == 2 * 8 + 8


def test_s2vae_main_train_resume_test(tmp_path):
    """``ode_rl_torch.main`` on S2VAE (narrowed): two steps, a resume to
    three from the checkpoint, then ``test_mmnist_s2vae`` from the train
    run's checkpoint with its BatchNorm buffers."""
    from ode_rl_torch.main import main

    narrow = ["--device", "cpu", "--logdir", str(tmp_path), "--batch_size",
              "2", "--d_zf", "16", "--slot_size", "8", "--train_in_seq",
              "12", "--train_out_seq", "3", "--epochs", "1",
              "--loss_log_freq", "1"]
    out = main(["--configs", "defaults", "train_mmnist_s2vae", *narrow,
                "--steps_per_epoch", "2"])
    assert out["final_step"] == 2 and np.isfinite(out["loss"])
    out = main(["--configs", "defaults", "train_mmnist_s2vae", *narrow,
                "--steps_per_epoch", "3"])
    assert out["final_step"] == 3
    run = tmp_path / "S2VAE" / "s2vae_mmnist_train_12_3"
    steps = [json.loads(line)["step"] for line in
             (run / "metrics.jsonl").read_text().splitlines()]
    assert steps == [1, 2, 3]
    saved = torch.load(sorted((run / "checkpoints").glob("*.ckpt"))[-1],
                       weights_only=True)["state"]["model"]
    assert not torch.all(saved["cnn_decoder.bn_0.mean"] == 0)
    out = main(["--configs", "defaults", "test_mmnist_s2vae", "--device",
                "cpu", "--logdir", str(tmp_path), "--batch_size", "2",
                "--test_in_seq", "12", "--test_out_seq", "4",
                "--eval_batches", "1"])
    per_horizon = json.loads((tmp_path / "S2VAE" / "s2vae_mmnist_test_12_4"
                              / "per_horizon.json").read_text())
    for k in ("mse", "psnr", "ssim"):
        assert len(per_horizon[k]) == 4 and np.all(np.isfinite(
            per_horizon[k]))
    assert out["final_mse"] == per_horizon["mse"][-1]
