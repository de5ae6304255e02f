"""Slice 1 of the PyTorch port against the JAX package: the whole
ODE-ConvGRU loss, prediction, solver stats and every gradient leaf from
converted weights in fp32, one Adam step against optax, and the fused
train step. Small shapes: batch 2, 32x32 frames (8x8 latent), 4 -> 4
frames, 64 channels so the GroupNorm groups stay above one.

Tolerances: fp32 sums are reassociated between XLA:CPU and torch, and the
drift grows over tens of field evaluations, so the prediction is held to
1e-4 max abs and each gradient leaf to 1e-3 relative L2; the stats are
integers and must be equal.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_util import (assert_grads_close, flax_grads_as_torch,
                             load_flax, max_abs, np32, rel_l2, t32)
from ode_rl_torch.config import FlagshipConfig
from ode_rl_torch.convert import flax_to_torch
from ode_rl_torch.models.odeconvgru import ODEConvGRUModel
from ode_rl_torch.train.step import (create_train_state, loss_and_grads,
                                     make_fused_train_step, make_optimizer)

B, T_IN, T_OUT, S, C = 2, 4, 4, 32, 64
MODEL_KW = dict(in_channels=1, n_downs=2, conv_encoder_out_ch=C,
                neural_ode_decoder_out_ch=C, neural_ode_n_units=C,
                n_ode_layers=3, rtol=1e-4, atol=1e-5, ode_max_steps=128)


def _batch_np(seed):
    rng = np.random.RandomState(seed)
    video = rng.uniform(-0.5, 0.5, (B, T_IN + T_OUT, S, S, 1))
    ts = np.arange(T_IN + T_OUT, dtype=np.float32) / (T_IN + T_OUT)
    return {"observed_data": video[:, :T_IN].astype(np.float32),
            "data_to_predict": video[:, T_IN:].astype(np.float32),
            "observed_tp": ts[:T_IN], "tp_to_predict": ts[T_IN:]}


@pytest.fixture(scope="module")
def jax_run():
    from ode_rl_tpu.models.odeconvgru import ODEConvGRUModel as FlaxModel

    model = FlaxModel(ode_solver="fast", method="dopri5", **MODEL_KW)
    batch = {k: jnp.asarray(v) for k, v in _batch_np(0).items()}
    params = model.init(jax.random.key(0), batch, method=model.loss)["params"]

    def loss_fn(p):
        loss, (metrics, pred) = model.apply({"params": p}, batch,
                                            method=model.loss)
        return loss, (metrics, pred)

    (loss, (metrics, pred)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = optax.adam(1e-4)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)
    return dict(params=params, loss=float(loss), pred=np.asarray(pred),
                metrics=jax.tree_util.tree_map(np.asarray, metrics),
                grads=grads, new_params=new_params)


@pytest.fixture(scope="module")
def torch_run(jax_run):
    model = ODEConvGRUModel(generator=torch.Generator().manual_seed(0),
                            **MODEL_KW)
    load_flax(model, jax_run["params"])
    batch = {k: t32(v) for k, v in _batch_np(0).items()}
    metrics, pred = loss_and_grads(model, batch)
    return dict(model=model, metrics=metrics, pred=pred)


def test_converter_covers_every_flax_leaf(jax_run, torch_run):
    """Every leaf of the flagship architecture's flax tree maps to exactly
    one parameter of the port, with its shape."""
    leaves = jax.tree_util.tree_leaves(jax_run["params"])
    state = flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                 jax_run["params"]))
    ours = torch_run["model"].state_dict()
    assert len(leaves) == len(state) == len(ours) == 40
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in ours.items()}


def test_model_loss_and_prediction_match_jax(jax_run, torch_run):
    assert max_abs(torch_run["pred"], jax_run["pred"]) <= 1e-4
    assert abs(float(torch_run["metrics"]["loss"]) - jax_run["loss"]) <= 1e-5


@pytest.mark.parametrize("stat", ["nfe", "ode_accepted", "ode_rejected",
                                  "ode_converged"])
def test_model_solver_stats_equal_jax(jax_run, torch_run, stat):
    assert torch_run["metrics"][stat] == int(jax_run["metrics"][stat])


def test_model_every_gradient_leaf_matches_jax(jax_run, torch_run):
    assert_grads_close(torch_run["model"], jax_run["grads"], 1e-3)


def test_first_adam_step_matches_optax(jax_run, torch_run):
    """The first Adam step is lr * g / (|g| + eps), which flips sign with
    noise on near-zero gradients: compare entries with |g| > 1e-6."""
    model = copy.deepcopy(torch_run["model"])
    for p, src in zip(model.parameters(), torch_run["model"].parameters()):
        p.grad = src.grad.clone()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = make_optimizer(FlagshipConfig(), model.parameters())
    opt.step()
    ref_after = flax_to_torch(jax.tree_util.tree_map(
        np.asarray, jax_run["new_params"]))
    ref_grads = flax_grads_as_torch(jax_run["grads"])
    for name, p in model.named_parameters():
        big = np.abs(np32(ref_grads[name])) > 1e-6
        ours = np32(p - before[name])[big]
        ref = np32(ref_after[name] - before[name])[big]
        assert rel_l2(ours, ref) <= 1e-3, name


def test_fused_train_step_runs_on_cpu():
    cfg = dataclasses.replace(FlagshipConfig(), batch_size=2,
                              train_in_seq=3, train_out_seq=3,
                              compute_dtype="float32")
    state = create_train_state(cfg, torch.device("cpu"))
    bank = torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, (5, 28, 28))).float()
    step = make_fused_train_step(cfg, bank)
    gen = torch.Generator().manual_seed(0)
    before = [p.detach().clone() for p in state.model.parameters()]
    metrics = step(state, gen)
    assert set(metrics) == {"loss", "mse", "nfe", "ode_accepted",
                            "ode_rejected", "ode_converged", "grad_norm"}
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    assert state.step == 1
    assert any(not torch.equal(a, b)
               for a, b in zip(before, state.model.parameters()))
