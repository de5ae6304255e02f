"""ConvLSTM, the plateau LR and early stopping, and ``debug_nans`` in the
port against the JAX package.

* ``ConvLSTMED`` narrowed (two encoder stages of 8 and 16 channels with
  16-feature cells, so the GroupNorm takes 2 groups; one 16-channel
  deconv; B=2, 16x16 frames, 3 -> 3) from JAX's init, ``convert.py``
  with the port's module (``dec_deconv_0`` and ``head_deconv`` flipped by
  their type): the prediction to 1e-5 max abs, the loss to 1e-5
  relative and every gradient leaf to 1e-4 relative L2 in fp32, through
  the fused scan driver and the unfused one (JAX's model runs fused);
* ``ReduceLROnPlateau`` and ``EarlyStopping`` against JAX's classes on
  the same metric sequences: the same scale and stop at every epoch;
* the plateau scale through a checkpoint, and the loop's monitor
  through ``ode_rl_torch.main``: ``train_mmnist_convlstm_sched`` with
  lr 0 (the validation MSE cannot improve), patience 0 and early
  stopping after 2 epochs: the scale halves twice and the run stops
  after the third epoch; a resume restores the scaled lr;
* ``debug_nans``: a NaN in the batch (forward) and a step whose forward
  is finite and whose backward makes a NaN both raise
  ``FloatingPointError`` in the port and under ``jax.debug_nans`` in
  JAX; a finite step's loss and parameters are the same with the flag as
  without it;
* ``ode_rl_torch.main`` on ``train_mmnist_convlstm``: train, resume and
  test (``--phase test``) at full width on a frozen corpus of 16x16
  frames.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import max_abs, rel_l2, t32
from ode_rl_torch.convert import flax_to_torch
from ode_rl_torch.core.checkpoint import CheckpointManager
from ode_rl_torch.core.config import load_config
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.main import main
from ode_rl_torch.models.convlstm import ConvLSTMED
from ode_rl_torch.train.schedulers import (EarlyStopping, ReduceLROnPlateau,
                                           lr_scale, set_lr_scale)
from ode_rl_torch.train.step import (TrainState, create_train_state,
                                     make_train_step)

B, S, T_IN, T_OUT = 2, 16, 3, 3
STAGES = (((8, 3, 2), 16), ((16, 3, 2), 16))
DECONVS = ((16, 4, 2),)


def _video(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, T_IN + T_OUT, S, S, 1) - 0.5).astype(np.float32)


def _jax_model():
    from ode_rl_tpu.models.convlstm import ConvLSTMED as JaxED
    return JaxED(in_channels=1, encoder_stages=STAGES,
                 decoder_deconvs=DECONVS)


def _jax_loss(model, v):
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    jb = jax_batch(jnp.asarray(v), n_in=T_IN)
    variables = jax.jit(lambda b: model.init(jax.random.key(0), b,
                                             method=model.loss))(jb)

    def loss_fn(p):
        loss, (metrics, pred) = model.apply({"params": p}, jb,
                                            method=model.loss)
        return loss, pred

    (loss, pred), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    return variables, loss, pred, grads


@pytest.mark.parametrize("fused", [True, False])
def test_convlstm_matches_jax(fused):
    model = _jax_model()
    v = _video()
    variables, j_loss, j_pred, j_grads = _jax_loss(model, v)
    port = ConvLSTMED(1, STAGES, DECONVS, fused=fused,
                      generator=torch.Generator().manual_seed(0))
    tree = jax.tree_util.tree_map(np.asarray, variables["params"])
    port.load_state_dict(flax_to_torch(tree, module=port), strict=True)
    loss, (metrics, pred) = port.loss(make_batch_dict(t32(v), T_IN))
    loss.backward()
    assert set(metrics) == {"loss", "mse"}
    assert tuple(pred.shape) == (B, T_OUT, S, S, 1)
    assert max_abs(pred, j_pred) <= 1e-5
    assert abs(float(loss.detach()) / float(j_loss) - 1) <= 1e-5
    ref = flax_to_torch(jax.tree_util.tree_map(np.asarray, j_grads),
                        module=port)
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert set(ref) == set(grads)
    for name in ref:
        assert rel_l2(grads[name], ref[name]) <= 1e-4, name
    # flax's GroupNorm: 4F/32 groups of contiguous channels, eps 1e-6.
    assert port.enc_cell_0.norm.num_groups == 2
    assert port.enc_cell_0.norm.EPS == 1e-6
    assert port.head_deconv.weight.shape == (16, 64, 4, 4)


# ------------------------------ schedulers ---------------------------------

SEQUENCES = {
    "stall": [1.0, 0.9, 0.9, 0.9, 0.9, 0.9, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8],
    "noisy": [0.5, 0.52, 0.49, 0.49 - 5e-13, 0.51, 0.49, 0.48, 0.6, 0.6,
              0.6, 0.47, 0.47, 0.47, 0.47],
    "floor": [1.0] * 40,
}


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
@pytest.mark.parametrize("factor,patience,min_scale,min_delta", [
    (0.5, 0, 1e-3, 0.0), (0.5, 2, 1e-3, 0.0), (0.1, 1, 0.05, 0.01)])
def test_schedulers_match_jax(seq, factor, patience, min_scale, min_delta):
    """The same scale and stop flag at every epoch; a change smaller than
    1e-12 is no improvement for the plateau."""
    from ode_rl_tpu.train import schedulers as js

    ours = ReduceLROnPlateau(factor, patience, min_scale)
    ref = js.ReduceLROnPlateau(factor, patience, min_scale)
    early = EarlyStopping(patience + 1, min_delta)
    jearly = js.EarlyStopping(patience + 1, min_delta)
    for metric in SEQUENCES[seq]:
        assert ours.step(metric) == ref.step(metric)
        assert early.step(metric) == jearly.step(metric)
        assert (ours.bad_epochs, early.counter) == (ref.bad_epochs,
                                                    jearly.counter)


def test_plateau_scale_survives_a_checkpoint(tmp_path):
    """``set_lr_scale`` writes lr = cfg.lr * scale into every param group
    with the scale beside it; a saved optimizer state loads both back."""
    cfg = load_config(["defaults", "train_mmnist_convlstm_sched"])
    state = create_train_state(cfg, torch.device("cpu"))
    set_lr_scale(state.optimizer, float(cfg.lr), 0.25)
    ckpt = CheckpointManager(tmp_path, tag="t")
    ckpt.save(7, {"optimizer": state.optimizer.state_dict()})
    fresh = create_train_state(cfg, torch.device("cpu"))
    assert fresh.optimizer.param_groups[0]["lr"] == cfg.lr
    restored = ckpt.restore({"optimizer": fresh.optimizer.state_dict()})
    fresh.optimizer.load_state_dict(restored["state"]["optimizer"])
    for group in fresh.optimizer.param_groups:
        assert group["lr"] == cfg.lr * 0.25 and group["lr_scale"] == 0.25
    assert lr_scale(fresh.optimizer.state_dict()) == 0.25


@pytest.fixture
def corpus(tmp_path):
    """A frozen corpus of 16x16 videos
    (tests/test_torch_port_recurrent_train.py)."""
    from test_torch_port_recurrent_train import _write_corpus
    return _write_corpus(tmp_path / "corpus", train_frames=20,
                         test_frames=20)


def _sched_argv(tmp_path, corpus, epochs):
    return ["--configs", "defaults", "train_mmnist_convlstm_sched",
            "--device", "cpu", "--logdir", str(tmp_path), "--data_dir",
            str(corpus), "--batch_size", "2", "--train_in_seq", "3",
            "--train_out_seq", "3", "--test_in_seq", "3", "--test_out_seq",
            "3", "--lr", "0.0", "--plateau_patience", "0",
            "--early_stop_patience", "2", "--steps_per_epoch", "1",
            "--epochs", str(epochs), "--loss_log_freq", "1"]


def test_main_plateau_and_early_stop(tmp_path, corpus, capsys):
    """Epoch 0 sets the best validation MSE; epochs 1 and 2 stall it
    (lr 0), so the scale halves at each and early stopping fires at
    epoch 2 of 5; the checkpoint holds the scale, and a resume trains on
    at the scaled lr."""
    out = main(_sched_argv(tmp_path, corpus, 5))
    assert out["final_step"] == 3
    printed = capsys.readouterr().out
    assert "lr scale 1 → 0.5" in printed
    assert "lr scale 0.5 → 0.25" in printed
    assert "early stop at epoch 2" in printed
    run = tmp_path / "ConvLSTM" / "ConvLSTM_sched_mmnist_train_3_3"
    logged = [json.loads(line) for line in
              (run / "metrics.jsonl").read_text().splitlines()]
    vals = [m["val_mse"] for m in logged if "val_mse" in m]
    assert len(vals) == 3 and len(set(vals)) == 1
    saved = torch.load(sorted((run / "checkpoints").glob("*.ckpt"))[-1],
                       weights_only=True)["state"]["optimizer"]
    assert lr_scale(saved) == 0.25
    # A resume restores the optimizer's scaled lr (0 * 0.25 here) and the
    # scale; its fresh plateau starts at 1, as JAX's does.
    out = main(_sched_argv(tmp_path, corpus, 6))
    assert "resumed from step 3" in capsys.readouterr().out
    saved = torch.load(sorted((run / "checkpoints").glob("*.ckpt"))[-1],
                       weights_only=True)["state"]["optimizer"]
    assert lr_scale(saved) in (0.25, 0.125)


# ------------------------------ debug_nans ---------------------------------

class _SqrtAtZero(torch.nn.Module):
    """A model whose forward is finite and whose backward makes a NaN:
    d sqrt(0 w) / dw = inf * 0."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor([1.5]))

    def loss(self, batch, generator=None):
        loss = torch.sqrt(self.w * 0.0).sum() + batch[
            "observed_data"].sum() * 0.0
        return loss, ({"loss": loss}, batch["observed_data"])


def test_debug_nans_raises_in_both_packages():
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    from ode_rl_tpu.train.step import create_train_state as jax_state
    from ode_rl_tpu.train.step import make_train_step as jax_train

    from ode_rl_tpu.core.config import load_config as jax_load

    v = _video()
    v[0, 1, 3, 3, 0] = np.nan
    jcfg = jax_load(["defaults", "train_mmnist_convlstm"])
    model = _jax_model()
    jb = jax_batch(jnp.asarray(_video()), n_in=T_IN)
    jstate = jax_state(model, jcfg, jb, jax.random.key(0))
    jstep = jax_train(model, donate=False)
    with jax.debug_nans(True), pytest.raises(FloatingPointError):
        jstep(jstate, jax_batch(jnp.asarray(v), n_in=T_IN), None)
    with jax.debug_nans(True), pytest.raises(FloatingPointError):
        jax.grad(lambda w: jnp.sum(jnp.sqrt(w * 0.0)))(jnp.array([1.5]))
    assert not jax.config.jax_debug_nans

    port = ConvLSTMED(1, STAGES, DECONVS,
                      generator=torch.Generator().manual_seed(0))
    state = TrainState(port, torch.optim.Adamax(port.parameters(), lr=1e-3))
    step = make_train_step(debug_nans=True)
    with pytest.raises(FloatingPointError, match="NaN in loss"):
        step(state, make_batch_dict(t32(v), T_IN))
    toy = _SqrtAtZero()
    toy_state = TrainState(toy, torch.optim.Adam(toy.parameters()))
    with pytest.raises(FloatingPointError, match="MulBackward"):
        step(toy_state, make_batch_dict(t32(_video()), T_IN))
    # Without the flag the same steps go through.
    make_train_step()(toy_state, make_batch_dict(t32(_video()), T_IN))


def test_debug_nans_leaves_a_finite_step_unchanged():
    batch = make_batch_dict(t32(_video()), T_IN)
    out = []
    for flag in (False, True):
        port = ConvLSTMED(1, STAGES, DECONVS,
                          generator=torch.Generator().manual_seed(0))
        state = TrainState(port, torch.optim.Adamax(port.parameters(),
                                                    lr=1e-3))
        m = make_train_step(debug_nans=flag)(state, batch)
        out.append((m, {n: p.detach().clone()
                        for n, p in port.named_parameters()}))
    (m0, p0), (m1, p1) = out
    assert float(m0["loss"]) == float(m1["loss"])
    assert float(m0["grad_norm"]) == float(m1["grad_norm"])
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name


def test_main_convlstm_train_resume_test(tmp_path, corpus):
    argv = ["--configs", "defaults", "train_mmnist_convlstm", "--device",
            "cpu", "--logdir", str(tmp_path), "--data_dir", str(corpus),
            "--batch_size", "2", "--train_in_seq", "3", "--train_out_seq",
            "3", "--epochs", "1", "--loss_log_freq", "1"]
    out = main([*argv, "--steps_per_epoch", "2"])
    assert out["final_step"] == 2 and np.isfinite(out["mse"])
    out = main([*argv, "--steps_per_epoch", "3"])
    assert out["final_step"] == 3
    out = main([*argv, "--phase", "test", "--load_model", "True",
                "--test_in_seq", "3", "--test_out_seq", "4",
                "--eval_batches", "1"])
    per_horizon = json.loads(
        (tmp_path / "ConvLSTM" / "ConvLSTM_mmnist_train_3_4"
         / "per_horizon.json").read_text())
    for k in ("mse", "psnr", "ssim"):
        assert len(per_horizon[k]) == 4 and np.all(np.isfinite(
            per_horizon[k]))
