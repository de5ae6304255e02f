"""Data parallelism against JAX, the recurrent families of
``__graft_entry__.py::dryrun_multichip`` at its shapes: ConvGRU
(``tests/test_mesh.py``: 16 channels, 3 -> 2, B=8), ConvLSTM (two small
stages, Adamax), the Dreamer world model (the RSSM's draws and its
free-bits clamp) and the imagination behavior step (actor, value and
slow target; the dry run's linear stand-in world model). Each starts
from JAX's init (``convert.py``) on JAX's batch, the stochastic ones
from the draws JAX's keys give, as tests/test_torch_port_wm_*.py compute
them. The port's step over 4 gloo ranks (ode_rl_torch/parallel/dryrun.py,
one spawn for the file; each rank draws at the global batch's shapes and
keeps its rows) is held to JAX's unsharded step and to the port's
one-process step at the dry run's tolerances: ConvGRU's and ConvLSTM's
loss 1e-5 relative; Dreamer's loss, KL and image loss 5e-4 plus 1e-4;
every scalar of the behavior step 2e-4 plus 1e-5; every gradient norm
1e-4 (the behavior's actor and value norms against JAX's read from its
Adam states after the step). The parameters after the step are
bit-equal across the ranks. ``convgru_sp`` is ConvGRU's dp x sp step of
tests/test_mesh.py::test_sp_sharded_train_step_matches_single_device (a
2 x 2 ('data', 'space') mesh, the frame height sharded) from ConvGRU's
inputs, held to the same references; the update of its parameters lies
within ``PARAM_TOL`` relative L2 of the one-process step's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_rl_torch.parallel import dryrun
from torch_port_parallel_util import (RANKS, first_step_grad_norm,
                                      load_named, load_typed, port_weights,
                                      run_families, scalars,
                                      tolerance_misses, train_case,
                                      train_state_and_step, video_batches)
from torch_port_util import KeyRecorder, rssm_observe_draws

FAMILIES = ("convgru", "convlstm", "dreamer", "behavior", "convgru_sp")
B = 8


def _convgru():
    from ode_rl_tpu.models.convgru import ConvGRUModel
    model = ConvGRUModel(in_channels=1, conv_encoder_out_ch=16,
                         convgru_out_ch=16)
    return train_case("convgru", model, {"lr": 1e-3, "clip": -1},
                      video_batches(5, 1), load_named)


def _convlstm():
    from ode_rl_tpu.models.convlstm import ConvLSTMED
    model = ConvLSTMED(in_channels=1,
                       encoder_stages=(((8, 3, 2), 16), ((16, 3, 2), 16)),
                       decoder_deconvs=((16, 4, 2),))
    return train_case("convlstm", model, {"lr": 1e-4, "clip": -1,
                                          "optimizer": "adamax"},
                      video_batches(6, 2), load_typed)


def _dreamer():
    from ode_rl_tpu.wm.rssm import RSSM as JaxRSSM
    from ode_rl_tpu.wm.world_model import DreamerVideoModel
    jb, pb = video_batches(6, 1)
    model = DreamerVideoModel(image_shape=(64, 64, 1), cnn_depth=8, stoch=8,
                              deter=16, hidden=16)
    state, step = train_state_and_step(model, {"lr": 3e-4, "clip": 100}, jb)
    rec = KeyRecorder()
    with pytest.MonkeyPatch.context() as mp:
        rec.wrap(mp, JaxRSSM, "observe", 1)
        _, metrics = step(state, jb, jax.random.key(1))
        jax.effects_barrier()
    assert [name for name, _ in rec.keys] == ["observe"]
    draws = rssm_observe_draws(rec.keys[0][1], 6, B, 8, 0)
    weights = port_weights("dreamer",
                           lambda s: load_typed(s.model, state.params))
    return ({"weights": weights, "batch": pb, "draws": draws},
            scalars(metrics))


def _behavior():
    from ode_rl_tpu.wm.behavior import ImagBehavior
    stoch, deter = 8, 16
    w_act = jax.random.normal(jax.random.key(9), (2, stoch)) * 0.1

    def img_step_fn(state, k, action):
        return {"stoch": jnp.tanh(state["stoch"] + action @ w_act),
                "deter": state["deter"]}

    def get_feat_fn(state):
        return jnp.concatenate([state["stoch"], state["deter"]], axis=-1)

    def reward_fn(feats, states, actions):
        return jnp.sum(feats[..., :stoch], axis=-1)

    beh = ImagBehavior(action_dim=2, feat_dim=24, actor_dist="tanh_normal",
                       horizon=4, units=32, layers=2, slow_target_update=2)
    state = beh.init(jax.random.key(3))
    step = beh.make_train_step(img_step_fn, get_feat_fn, reward_fn)
    start = {"stoch": jax.random.normal(jax.random.key(4), (B, stoch)),
             "deter": jnp.zeros((B, deter))}
    key = jax.random.key(5)
    # The actor's rollout, then the value's: one key a step, split into
    # the action's key and the (unused) transition's.
    draws = [("normal", np.asarray(jax.random.normal(
        jax.random.split(kk)[0], (B, 2)), np.float32))
        for k in jax.random.split(key) for kk in jax.random.split(k, 4)]

    def load(s):
        b = s["behavior"]
        load_typed(b.actor, state.actor_params["params"])
        load_typed(b.value, state.value_params["params"])
        load_typed(b.slow_value, state.slow_value_params["params"])
        s["world"].w_act.copy_(torch.from_numpy(np.array(w_act)))

    weights = port_weights("behavior", load)
    new, metrics = step(state, start, key)
    ref = scalars(metrics)
    ref["actor_grad_norm"] = first_step_grad_norm(new.actor_opt)
    ref["value_grad_norm"] = first_step_grad_norm(new.value_opt)
    return ({"weights": weights, "draws": draws,
             "batch": {k: np.asarray(v) for k, v in start.items()}}, ref)


@pytest.fixture(scope="module")
def runs():
    convgru = _convgru()
    return run_families({"convgru": convgru, "convlstm": _convlstm(),
                         "dreamer": _dreamer(), "behavior": _behavior(),
                         "convgru_sp": convgru})


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_step_matches_jax_unsharded(runs, name):
    result, ref = runs[name]
    assert tolerance_misses(name, result["sharded"], ref) == []


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_step_matches_the_one_process_step(runs, name):
    result, _ = runs[name]
    assert tolerance_misses(name, result["sharded"], result["single"]) == []


@pytest.mark.parametrize("name", FAMILIES)
def test_parameters_bit_equal_across_ranks(runs, name):
    result, _ = runs[name]
    assert result["params_equal"]
    assert result["grad_bytes"] > 0
    assert len(result["rank_launches"]) == RANKS


def test_convgru_sp_parameters_match_the_one_process_step(runs):
    result, _ = runs["convgru_sp"]
    assert result["update_rel_l2"] <= dryrun.FAMILIES[
        "convgru_sp"]().param_tol
