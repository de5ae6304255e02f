"""S3VAE's training path in the port against the JAX package: three
train steps of the 'default' and 'cgru' models (Adam; 'cgru' with its
block's clip), the BatchNorm buffers after them, an eval-mode forward on
the trained weights and running statistics, the motion-grid labels
(ties), and the entry point on the CPU (``main``: train, resume,
test 20 -> 180; TF32 off after it). Helpers, sizes and tolerances in
tests/test_torch_port_s3vae.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import max_abs, np32, rel_l2, t32
from test_torch_port_s3vae import (B, LOSS_TOL, METRIC_FLOOR, METRICS,
                                   OUT_TOL, T_IN, JaxGradsF64, Recorder,
                                   Replay, assert_buffers_close,
                                   assert_grads_match, configs, f64_batch,
                                   jax_init, load_port, port_f64,
                                   port_loss_and_grads, size_for, video)
from ode_rl_torch.data.flow_labels import motion_grid_labels
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.train.step import create_train_state, make_train_step

NORM_TOL = 1e-4
# The port's fp64 gradients against JAX's fp64 ones (the ConvGRU's gate
# GroupNorm takes its moments in fp32 on both sides).
F64_RTOL, F64_ATOL = 1e-5, 1e-8


def _as_flax(state_dict, template):
    """The port's parameters (or buffers) in the flax tree ``template``:
    the inverse of ``flax_to_torch``, as copies."""
    from ode_rl_torch.convert import _is_field_conv, _is_transposed_conv

    def leaf(path, ref):
        layer, name = path[-2], path[-1]
        if name != "kernel" or ref.ndim != 4 or _is_field_conv(layer):
            w = np32(state_dict[".".join(path)])
        else:
            w = np32(state_dict[".".join(path[:-1] + ("weight",))])
            w = (np.flip(w.transpose(2, 3, 0, 1), (0, 1))
                 if _is_transposed_conv(layer) else w.transpose(2, 3, 1, 0))
        assert w.shape == ref.shape, path
        return jnp.asarray(np.ascontiguousarray(w).copy())

    return jax.tree_util.tree_map_with_path(
        lambda kp, ref: leaf(tuple(k.key for k in kp), ref), template)


@pytest.mark.parametrize("block", ["train_mmnist_recon_s3vae",
                                   "train_mmnist_recon_cs3vae"])
def test_three_train_steps_match_jax(block, monkeypatch):
    """Three train steps on three batches, each from the same state on
    both sides (the port's parameters and BatchNorm buffers copied into
    JAX's state; JAX's Adam state carried from its own steps): the loss
    and the eight metrics against JAX's step to 1e-5 relative, grad_norm
    to 1e-4 of JAX's fp64 norm (the port's fp32 norm of the 'default'
    model's gradient lies 1.5e-5 from it: it sums the leaves' rounding),
    the BatchNorm buffers after the step against JAX's ``batch_stats`` to
    1e-5, and the step's gradients, every leaf, of the port in fp64 (a
    copy of its state) against JAX's in fp64 to 1e-5 relative L2 plus 1e-8
    of the whole norm. In fp32 the second step's state is ill-conditioned:
    the port's fp32 gradients of the 'default' model lie up to 1.5e-3
    from JAX's fp64 ones (the decoder's first BatchNorm bias), where its
    fp64 ones lie 2.3e-7 from them (the readings printed by
    ``python tests/test_torch_port_s3vae.py``). Then,
    on the trained weights and running statistics, an eval-mode
    prediction (t_in + n_out frames) against JAX's.

    Run free instead, the two sides part at once: Adam's first update is
    lr * sign(g) in every element, so an element whose gradient lies
    within rounding of zero moves by +-lr on each side at random; the
    biases before a training-mode BatchNorm (gradient zero in exact
    arithmetic) are made of such elements, and JAX's own fp32 gradients
    of the 'default' model lie up to 4.4e-3 from its fp64 ones."""
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    from ode_rl_tpu.train.step import TrainState, make_optimizer
    from ode_rl_tpu.train.step import make_train_step as jax_train

    jcfg, cfg = configs(block)
    size = size_for(cfg)
    videos = [video(i, size) for i in range(3)]
    jbs = [jax_batch(jnp.asarray(v), n_in=T_IN, with_flow_labels=True)
           for v in videos]
    model, variables = jax_init(jcfg, jbs[0])
    tx = make_optimizer(jcfg)
    jstate = TrainState(step=jnp.asarray(0, jnp.int32),
                        params=variables["params"],
                        model_state={"batch_stats": variables["batch_stats"]},
                        opt_state=tx.init(variables["params"]), tx=tx)
    state = create_train_state(cfg, torch.device("cpu"))
    assert state.clip == float(cfg.get("clip", -1))
    load_port(state.model, variables)
    jstep = jax_train(model, donate=False)
    grads64 = JaxGradsF64(model, True)
    step = make_train_step()
    moved, draws = [], None
    for i, (v, jb) in enumerate(zip(videos, jbs)):
        sd = state.model.state_dict()
        synced = {"params": _as_flax(sd, jstate.params),
                  "batch_stats": _as_flax(
                      sd, jstate.model_state["batch_stats"])}
        jstate = jstate.replace(
            params=synced["params"],
            model_state={"batch_stats": synced["batch_stats"]})
        ref64 = grads64(synced, jb)
        rec = Recorder()
        with monkeypatch.context() as mp:
            rec.patch(mp)
            jstate, jm = jstep(jstate, jb, jax.random.key(i))
        # The step is traced once, so its draws are the first step's.
        draws = draws or rec.draws
        buffers = {n: b.clone() for n, b in state.model.named_buffers()}
        batch = make_batch_dict(t32(v), T_IN, with_flow_labels=True)
        port64 = port_f64(state.model)
        port_loss_and_grads(port64, f64_batch(batch), Replay(draws), True)
        m = step(state, batch, Replay(draws))
        for k in METRICS:
            ref = float(jm[k])
            assert abs(float(m[k]) - ref) / max(abs(ref), METRIC_FLOOR) \
                <= LOSS_TOL, (i, k)
        norm64 = float(torch.sqrt(sum(torch.sum(g ** 2)
                                      for g in ref64.values())))
        assert abs(float(m["grad_norm"]) / norm64 - 1.0) <= NORM_TOL, i
        assert_grads_match(port64, ref64, rtol=F64_RTOL, atol=F64_ATOL)
        assert_buffers_close(state.model, jstate.model_state["batch_stats"])
        moved.append(max(rel_l2(b, buffers[n])
                         for n, b in state.model.named_buffers()))
    assert state.step == 3 and min(moved) > 1e-4

    # Eval mode on the trained weights and running statistics.
    sd = state.model.state_dict()
    trained = {"params": _as_flax(sd, jstate.params),
               "batch_stats": _as_flax(sd,
                                       jstate.model_state["batch_stats"])}
    v = video(7, size, t=T_IN + 4)
    jb = jax_batch(jnp.asarray(v), n_in=T_IN, with_flow_labels=True)
    rec = Recorder()
    with monkeypatch.context() as mp:
        rec.patch(mp)
        j_pred, _ = jax.jit(lambda b: model.apply(
            trained, b, train=False, method=model.predict,
            rngs={"sample": jax.random.key(3)}))(jb)
    state.model.eval()
    with torch.no_grad():
        pred, _ = state.model.predict(make_batch_dict(t32(v), T_IN),
                                      Replay(rec.draws))
    assert pred.shape == j_pred.shape == (B, T_IN + 4, size, size, 1)
    assert max_abs(pred, j_pred) <= OUT_TOL
# --------------------------- the motion labels ----------------------------

def test_motion_labels_keep_ties_as_jax():
    """Motion in two cells of a 12x12 frame: every still cell ties with
    the third largest (0), so all nine labels are 1 on both sides (three
    would be ``torch.topk``'s); then seeded Moving MNIST batches."""
    from ode_rl_tpu.data.flow_labels import motion_grid_labels as jax_labels
    from ode_rl_tpu.data.mmnist import generate_moving_mnist as jax_mmnist
    from ode_rl_tpu.data.sprites import get_sprite_bank

    video = np.zeros((1, 2, 12, 12, 1), np.float32)
    video[0, 1, 0:4, 0:4] = 1.0
    video[0, 1, 8:12, 4:8] = 0.5
    ours = motion_grid_labels(t32(video))
    assert torch.equal(ours, torch.ones(1, 1, 9))
    assert np.array_equal(np32(ours), np32(jax_labels(jnp.asarray(video))))
    bank = jnp.asarray(get_sprite_bank(None))
    for seed in range(3):
        v = np.asarray(jax_mmnist(jax.random.key(seed), bank, batch=2,
                                  n_frames=8, num_digits=2)) + 0.5
        ref = np32(jax_labels(jnp.asarray(v)))
        assert np.array_equal(np32(motion_grid_labels(t32(v))), ref)
        batch = make_batch_dict(t32(v - 0.5), 5, with_flow_labels=True)
        assert np.array_equal(np32(batch["in_flow_labels"]), ref[:, :4])
        assert torch.equal(batch["in_flow_labels"], batch["out_flow_labels"])


# ----------------------------- the entry point ----------------------------

def _narrow_argv(corpus, logdir):
    return ["--device", "cpu", "--data_dir", str(corpus), "--logdir",
            str(logdir), "--encoder_out_dims", "16", "--d_zf", "8",
            "--d_zt", "8", "--batch_size", "2", "--train_in_seq", "3",
            "--train_out_seq", "3", "--loss_log_freq", "1"]


def test_main_trains_resumes_and_tests_cs3vae(tmp_path):
    """``defaults train_mmnist_recon_cs3vae`` (narrowed) trains two steps
    with a checkpoint, resumes for a third, and ``test_mmnist_recon_cs3vae``
    tests 20 -> 180 from it (200 values of each metric), with the
    BatchNorm buffers restored from the checkpoint; TF32 is off after
    ``main``."""
    from ode_rl_torch.core.checkpoint import CheckpointManager
    from ode_rl_torch.main import main

    corpus = tmp_path / "frozen"
    rng = np.random.RandomState(0)
    for split, n, frames in (("train", 4, 12), ("test", 2, 200)):
        (corpus / split).mkdir(parents=True)
        np.save(corpus / split / "shard_0000.npy",
                rng.randint(0, 256, (n, frames, 32, 32), dtype=np.uint8))
    (corpus / "meta.json").write_text(json.dumps({"frames": 12}))
    logs = tmp_path / "logs"
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        argv = ["--configs", "defaults", "train_mmnist_recon_cs3vae",
                *_narrow_argv(corpus, logs), "--steps_per_epoch", "2",
                "--epochs", "1", "--ckpt_save_freq", "2"]
        out = main(argv)
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    assert out["final_step"] == 2 and set(out) >= METRICS | {"grad_norm"}
    run = logs / "S3VAE" / "recon_cs3vae_mmnist_train_3_3"
    logged = [json.loads(line) for line in
              (run / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in logged] == [1, 2]
    for m in logged:
        assert all(np.isfinite(m[k]) for k in METRICS | {"grad_norm"})
    ckpt = CheckpointManager(run / "checkpoints",
                             tag="train_mmnist_recon_cs3vae")
    state = ckpt.restore({"model": {}, "optimizer": {}})["state"]["model"]
    assert not torch.equal(state["conv_encoder.bn_0.var"],
                           torch.ones_like(state["conv_encoder.bn_0.var"]))

    out = main([*argv[:-4], "--steps_per_epoch", "3", "--epochs", "1",
                "--ckpt_save_freq", "3"])
    assert out["final_step"] == 3

    out = main(["--configs", "defaults", "test_mmnist_recon_cs3vae",
                "--device", "cpu", "--data_dir", str(corpus), "--logdir",
                str(logs), "--eval_batches", "1", "--batch_size", "2"])
    run = logs / "S3VAE" / "recon_cs3vae_mmnist_test_20_180"
    per_horizon = json.loads((run / "per_horizon.json").read_text())
    assert set(per_horizon) == {"mse", "psnr", "ssim"}
    for k, v in per_horizon.items():
        assert len(v) == 200 and np.all(np.isfinite(v)), k
