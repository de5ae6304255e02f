"""The train step's options in the port against optax and the JAX package,
and the recurrent family through the port's entry point on the CPU.

* ``clip``: ``optax.clip_by_global_norm`` below, at and above the
  threshold (kept where norm < clip, else g / norm * clip), bit for bit;
* ``optimizer: adamax``: three steps against ``optax.adamax``, each
  update to 1e-5 relative;
* ``nan_guard``: a NaN batch, then a finite one, against the JAX step:
  the first keeps the parameters (``nan_skipped`` 1), the second leaves
  NaN in the same parameter elements on both sides (the optimizer's
  state took the NaN step, as in JAX);
* three train steps of ConvGRU, of cgrudecODE, and of ConvGRU with
  ``clip`` and ``adamax``, against the JAX step on the same batches from
  JAX's init (32 channels, batch 2, 16x16 frames, 4 -> 4 frames): each
  loss to 1e-5 relative, each parameter leaf to 1e-4 relative L2 (as
  tests/test_torch_port_recipe.py); ConvGRU runs free, cgrudecODE's
  steps start from the same parameters on both sides (see the test);
* ``ode_rl_torch.main`` on ``--device cpu`` at 16 channels on a frozen
  corpus: each of the five training blocks trains a step;
  ``train_mmnist_cgru_len20`` trains, resumes and tests 10 -> 190; and
  ``test_mmnist_odecgrumem_len20_1ch`` (``n_ode_layers: 2``) restores the
  train block's 3 layers from the saved config, as JAX's test phase does.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_util import load_flax, np32, rel_l2, t32
from ode_rl_torch.convert import flax_to_torch
from ode_rl_torch.core.config import load_config
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.main import main
from ode_rl_torch.train.step import (clip_by_global_norm, create_train_state,
                                     global_norm, make_train_step)

C, B, S, T_IN, T_OUT = 32, 2, 16, 4, 4
NARROW = dict(conv_encoder_out_ch=C, convgru_out_ch=C, latent_dim=C,
              neural_ode_decoder_out_ch=C, neural_ode_n_units=C,
              batch_size=B, train_in_seq=T_IN, train_out_seq=T_OUT)
CGRU = ["defaults", "train_mmnist_cgru_len20"]


def _videos(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(B, T_IN + T_OUT, S, S, 1) - 0.5).astype(np.float32)
            for _ in range(n)]


# ------------------------------ optimizer ----------------------------------

def _grads(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(3, 4).astype(np.float32),
            rng.randn(5).astype(np.float32)]


@pytest.mark.parametrize("where", ["below", "at", "above"])
def test_clip_matches_optax(where):
    # 3-4-12 has the exact norm 13, so "at" is exactly at the threshold.
    grads = ([np.array([3.0, 4.0], np.float32), np.array([12.0], np.float32)]
             if where == "at" else _grads())
    tg = [t32(g) for g in grads]
    norm = global_norm(tg)
    max_norm = {"below": 2.0 * float(norm), "at": 13.0,
                "above": float(norm) / 3.0}[where]
    ours = clip_by_global_norm(tg, norm, max_norm)
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    for a, b, g in zip(ours, ref, grads):
        assert np.array_equal(np32(a), np.asarray(b))
        if where == "below":
            assert np.array_equal(np32(a), g)
        else:
            assert not np.array_equal(np32(a), g) or where == "at"
    if where == "above":
        assert abs(float(global_norm(ours)) - max_norm) <= 1e-6 * max_norm


def test_adamax_matches_optax():
    cfg = load_config(CGRU).replace(optimizer="adamax", lr=1e-2)
    params = _grads(seed=1)
    tparams = [t32(p).requires_grad_(True) for p in params]
    from ode_rl_torch.train.step import make_optimizer
    opt = make_optimizer(cfg, tparams)
    assert isinstance(opt, torch.optim.Adamax)
    tx = optax.adamax(1e-2)
    jparams = [jnp.asarray(p) for p in params]
    state = tx.init(jparams)
    for i in range(3):
        grads = _grads(seed=10 + i)
        before = [np32(p).copy() for p in tparams]
        for p, g in zip(tparams, grads):
            p.grad = t32(g)
        opt.step()
        updates, state = tx.update([jnp.asarray(g) for g in grads], state)
        jparams = optax.apply_updates(jparams, updates)
        for p, b, u in zip(tparams, before, updates):
            assert rel_l2(np32(p) - b, u) <= 1e-5, i


# ------------------------- steps against JAX --------------------------------

def _jax_state(blocks, overrides, video):
    from ode_rl_tpu.core.config import load_config as jax_load
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    from ode_rl_tpu.models.registry import build_model as jax_build
    from ode_rl_tpu.train.step import TrainState, make_optimizer

    cfg = jax_load(blocks, overrides={**NARROW, **overrides})
    model = jax_build(cfg)
    init = jax.jit(functools.partial(model.init, method=model.loss))
    params = init(jax.random.key(0), jax_batch(jnp.asarray(video),
                                               n_in=T_IN))["params"]
    tx = make_optimizer(cfg)
    return model, TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                             model_state={}, opt_state=tx.init(params), tx=tx)


def _port_state(blocks, overrides, jax_params):
    cfg = load_config(blocks, overrides={**NARROW, **overrides})
    state = create_train_state(cfg, torch.device("cpu"))
    load_flax(state.model, jax_params)
    return state


def _as_flax(model: torch.nn.Module, template):
    """A copy of the port's parameters in the flax tree ``template`` (the
    inverse of ``flax_to_torch``). A copy: JAX may alias a numpy buffer,
    and the port's next step updates its parameters in place."""
    from ode_rl_torch.convert import _is_field_conv, _is_transposed_conv

    params = dict(model.named_parameters())

    def leaf(path, ref):
        layer, name = path[-2], path[-1]
        if name != "kernel" or _is_field_conv(layer):
            return jnp.array(np32(params[".".join(path)]).copy())
        w = np32(params[".".join(path[:-1] + ("weight",))])
        w = (np.flip(w.transpose(2, 3, 0, 1), (0, 1))
             if _is_transposed_conv(layer) else w.transpose(2, 3, 1, 0))
        assert w.shape == ref.shape, path
        return jnp.asarray(np.ascontiguousarray(w))

    return jax.tree_util.tree_map_with_path(
        lambda kp, ref: leaf(tuple(k.key for k in kp), ref), template)


@pytest.mark.parametrize("block,overrides", [
    ("train_mmnist_cgru_len20", {}),
    ("train_mmnist_cgrudecODE", {}),
    ("train_mmnist_cgru_len20", {"clip": 0.005, "optimizer": "adamax"})])
def test_three_train_steps_match_jax(block, overrides):
    """Three steps on the same batches from JAX's init: each loss and the
    raw gradients' norm to 1e-5 relative, and after each step every
    parameter leaf to 1e-4 relative L2 and its update to 1e-3. ConvGRU,
    with and without clip and adamax, runs free for the three steps.

    cgrudecODE's step starts from the same parameters on both sides (the
    port's, copied into JAX's state; JAX's optimizer state is carried
    from its own previous step). Run free, its decode field's leaves
    drift 1e-4 from JAX by step 2 and 2e-3 by step 3: some of their
    gradient elements are about 1e-8, the size of Adam's eps, so a
    rounding difference there moves an update by a share of the learning
    rate. Each side drifts as far from itself when its initial parameters
    are multiplied by 1 + 1e-7 noise (PERF.md, PR 10's entry), so no two
    orders of summation would hold 1e-4 there."""
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    from ode_rl_tpu.train.step import make_train_step as jax_train

    blocks = ["defaults", block]
    resync = block == "train_mmnist_cgrudecODE"
    videos = _videos()
    model, jstate = _jax_state(blocks, overrides, videos[0])
    state = _port_state(blocks, overrides, jstate.params)
    assert state.clip == float(overrides.get("clip", -1))
    jstep = jax_train(model, donate=False)
    step = make_train_step()
    clipped = 0
    for i, video in enumerate(videos):
        if resync:
            jstate = jstate.replace(params=_as_flax(state.model,
                                                    jstate.params))
        before = {n: np32(p).copy() for n, p in
                  state.model.named_parameters()}
        j_before = flax_to_torch(jax.tree_util.tree_map(
            lambda a: np.array(a), jstate.params))
        jstate, jm = jstep(jstate, jax_batch(jnp.asarray(video), n_in=T_IN),
                           None)
        m = step(state, make_batch_dict(t32(video), T_IN))
        assert abs(float(m["loss"]) / float(jm["loss"]) - 1.0) <= 1e-5, i
        # grad_norm is the norm of the raw gradients, before the clip.
        assert abs(float(m["grad_norm"]) / float(jm["grad_norm"])
                   - 1.0) <= 1e-5, i
        clipped += float(m["grad_norm"]) >= overrides.get("clip", np.inf)
        after = flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                     jstate.params))
        for name, p in state.model.named_parameters():
            assert rel_l2(p, after[name]) <= 1e-4, (i, name)
            # The update itself, a function of the gradients (1e-3).
            assert rel_l2(np32(p) - before[name],
                          after[name].numpy() - j_before[name].numpy()
                          ) <= 1e-3, (i, name)
    assert state.step == 3
    if "clip" in overrides:
        assert clipped == 3


def test_nan_guard_matches_jax():
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    from ode_rl_tpu.train.step import make_train_step as jax_train

    nan_video, video = _videos(2)
    nan_video[0, 1, 3, 3, 0] = np.nan
    model, jstate = _jax_state(CGRU, {}, video)
    state = _port_state(CGRU, {}, jstate.params)
    init = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    jstep = jax_train(model, donate=False, nan_guard=True)
    step = make_train_step(nan_guard=True)

    jstate, jm = jstep(jstate, jax_batch(jnp.asarray(nan_video), n_in=T_IN),
                       None)
    m = step(state, make_batch_dict(t32(nan_video), T_IN))
    assert int(m["nan_skipped"]) == int(jm["nan_skipped"]) == 1
    for name, p in state.model.named_parameters():
        assert torch.equal(p, init[name]), name

    jstate, jm = jstep(jstate, jax_batch(jnp.asarray(video), n_in=T_IN),
                       None)
    m = step(state, make_batch_dict(t32(video), T_IN))
    assert int(m["nan_skipped"]) == int(jm["nan_skipped"]) == 0
    final = flax_to_torch(jax.tree_util.tree_map(np.asarray, jstate.params))
    n_nan = 0
    for name, p in state.model.named_parameters():
        ours, ref = np32(p), np.asarray(final[name])
        assert np.array_equal(np.isnan(ours), np.isnan(ref)), name
        n_nan += int(np.isnan(ours).sum())
        finite = ~np.isnan(ref)
        assert rel_l2(ours[finite], ref[finite]) <= 1e-4, name
    assert n_nan > 0


# ----------------------------- entry point ----------------------------------

def _write_corpus(root, train_frames=100, test_frames=200):
    rng = np.random.RandomState(0)
    for split, n, frames in (("train", 4, train_frames),
                             ("test", 2, test_frames)):
        (root / split).mkdir(parents=True)
        np.save(root / split / "shard_0000.npy",
                rng.randint(0, 256, (n, frames, S, S), dtype=np.uint8))
    (root / "meta.json").write_text(json.dumps({"frames": test_frames}))
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _write_corpus(tmp_path_factory.mktemp("frozen"))


def _argv(corpus, logdir):
    return ["--device", "cpu", "--data_dir", str(corpus), "--logdir",
            str(logdir), "--batch_size", "2", "--quiet", "True"] + [
        a for k in ("conv_encoder_out_ch", "convgru_out_ch",
                    "neural_ode_decoder_out_ch", "neural_ode_n_units")
        for a in (f"--{k}", "16")]


def _logged(run):
    return [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("block,model,run_id,keys", [
    ("train_mmnist_cgru_len20", "ConvGRU", "ConvGRU_mmnist_train_10_10",
     set()),
    ("train_mmnist_cgrudecODE", "cgrudecODE", "cgrudecODE_mmnist_train_50_50",
     {"nfe", "ode_converged"}),
    ("train_mmnist_odecgrumem_len20_1ch", "ODEConv",
     "ODEConv_mmnist_train_10_10", {"nfe"}),
    ("train_mmnist_odecgrumem2_len20_1ch", "ODEConv",
     "ODEConv_mmnist_train_10_10", {"nfe"}),
    ("train_mmnist_sample_odecgru", "ODEConv",
     "ODEConv_sample_mmnist_train_50_50",
     {"nfe", "ode_accepted", "ode_rejected", "ode_converged", "z0_kl",
      "nan_skipped"})])
def test_main_trains_each_block(corpus, tmp_path, block, model, run_id, keys):
    out = main(["--configs", "defaults", block, *_argv(corpus, tmp_path),
                "--steps_per_epoch", "1", "--epochs", "1"])
    assert out["final_step"] == 1 and np.isfinite(out["loss"])
    (logged,) = _logged(tmp_path / model / run_id)
    assert set(logged) == {"step", "wall_s", "loss", "mse", "grad_norm",
                           *keys}
    assert all(np.isfinite(v) for v in logged.values())


def test_main_cgru_trains_resumes_and_tests_190_frames(corpus, tmp_path):
    argv = _argv(corpus, tmp_path) + ["--steps_per_epoch", "2",
                                      "--ckpt_save_freq", "2",
                                      "--loss_log_freq", "1"]
    out = main(["--configs", *CGRU, *argv, "--epochs", "1"])
    assert out["final_step"] == 2
    out = main(["--configs", *CGRU, *argv, "--epochs", "2"])
    assert out["final_step"] == 4
    run = tmp_path / "ConvGRU" / "ConvGRU_mmnist_train_10_10"
    assert [m["step"] for m in _logged(run)] == [1, 2, 3, 4]

    out = main(["--configs", "defaults", "test_mmnist_cgru_len20",
                *_argv(corpus, tmp_path), "--eval_batches", "2"])
    run = tmp_path / "ConvGRU" / "ConvGRU_mmnist_test_10_190"
    per_horizon = json.loads((run / "per_horizon.json").read_text())
    assert set(per_horizon) == {"mse", "psnr", "ssim"}
    for k, v in per_horizon.items():
        assert len(v) == 190 and np.all(np.isfinite(v)), k
        assert out[f"final_{k}"] == v[-1]


def test_memory_test_block_restores_the_train_blocks_layers(corpus,
                                                            tmp_path):
    from ode_rl_tpu.core.config import Config as JaxConfig
    from ode_rl_tpu.train.loop import _resurrect_train_config as jax_merge
    from ode_rl_torch.core.checkpoint import CheckpointManager
    from ode_rl_torch.train.loop import _resurrect_train_config

    main(["--configs", "defaults", "train_mmnist_odecgrumem_len20_1ch",
          *_argv(corpus, tmp_path), "--steps_per_epoch", "1", "--epochs",
          "1"])
    test_argv = ["--configs", "defaults", "test_mmnist_odecgrumem_len20_1ch",
                 *_argv(corpus, tmp_path), "--eval_batches", "1",
                 "--test_out_seq", "5"]
    from ode_rl_torch.main import get_cfg
    test_cfg, _ = get_cfg(test_argv)
    assert test_cfg.n_ode_layers == 2
    saved = CheckpointManager(
        tmp_path / "ODEConv" / "ODEConv_mmnist_train_10_10" / "checkpoints",
        tag="train_mmnist_odecgrumem_len20_1ch").load_config()
    merged = _resurrect_train_config(test_cfg, saved)
    assert merged.n_ode_layers == 3 and merged.mem
    assert merged.to_dict() == dict(jax_merge(JaxConfig(test_cfg.to_dict()),
                                              saved).to_dict())
    # The checkpoint of 3 layers loads into the model the merged config
    # builds, and the test runs.
    main(test_argv)
    per_horizon = json.loads((tmp_path / "ODEConv"
                              / "ODEConv_mmnist_test_10_5"
                              / "per_horizon.json").read_text())
    assert all(len(v) == 5 and np.all(np.isfinite(v))
               for v in per_horizon.values())
