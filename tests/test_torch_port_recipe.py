"""The training recipe's path in the port against the JAX package:
``defaults`` + ``train_mmnist_odecgru_len20_1ch`` (ODEConv, fp32, dopri5
'scan' with remat, frozen batches), narrowed to 32 channels, batch 2,
16x16 frames, 4 -> 4 frames, both models built by their registries from
one config and the port loaded with JAX's init (``convert.py``).

Tolerances: the prediction to 1e-4 max abs and each gradient leaf to 1e-3
relative L2 (as tests/test_torch_port_slice.py: fp32 sums reassociate
between XLA:CPU and torch over tens of field evaluations); the solver
stats equal. Three train steps on the same frozen batches: each loss to
1e-5 relative, each final parameter leaf to 1e-4 relative L2. The eval
step's per-horizon MSE, PSNR and SSIM to 1e-5 (absolute plus relative,
as numpy's allclose: the MSE of a prediction 1e-7 off moves by about
1e-7), its aux stats equal. Then the entry point, ``ode_rl_torch.main.main``, trains and
tests on the CPU: checkpoints written and found, ``per_horizon.json`` of
the test horizon's length, and a second run resumes from the saved step.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (assert_grads_close, load_flax, max_abs, np32,
                             rel_l2, t32)
from ode_rl_torch.convert import flax_to_torch
from ode_rl_torch.core.config import load_config
from ode_rl_torch.data.frozen import FrozenMovingMNIST
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.main import main
from ode_rl_torch.train.step import (create_train_state, loss_and_grads,
                                     make_eval_step, make_train_step)

RECIPE = ["defaults", "train_mmnist_odecgru_len20_1ch"]
C, B, S, T_IN, T_OUT = 32, 2, 16, 4, 4
NARROW = dict(conv_encoder_out_ch=C, neural_ode_decoder_out_ch=C,
              neural_ode_n_units=C, batch_size=B, train_in_seq=T_IN,
              train_out_seq=T_OUT)


def _write_corpus(root, frames=24, size=S):
    rng = np.random.RandomState(0)
    for split, n in (("train", 6), ("test", 4)):
        (root / split).mkdir(parents=True)
        np.save(root / split / "shard_0000.npy",
                rng.randint(0, 256, (n, frames, size, size), dtype=np.uint8))
    (root / "meta.json").write_text(json.dumps({"frames": frames}))
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _write_corpus(tmp_path_factory.mktemp("frozen"))


@pytest.fixture(scope="module")
def batches(corpus):
    loader = FrozenMovingMNIST(corpus, B, T_IN, T_OUT, seed=0)
    return [next(loader).numpy() for _ in range(4)]


@pytest.fixture(scope="module")
def jax_side(batches):
    from ode_rl_tpu.core.config import load_config as jax_load
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    from ode_rl_tpu.models.registry import build_model as jax_build
    from ode_rl_tpu.train.step import (TrainState, make_eval_step as
                                       jax_eval, make_optimizer,
                                       make_train_step as jax_train)

    cfg = jax_load(RECIPE, overrides=NARROW)
    model = jax_build(cfg)
    jb = [jax_batch(jnp.asarray(v), n_in=T_IN) for v in batches]
    # create_train_state's init, under jit (4 s on the CPU, not 17).
    init = jax.jit(functools.partial(model.init, method=model.loss))
    params = init(jax.random.key(0), jb[0])["params"]
    tx = make_optimizer(cfg)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                       model_state={}, opt_state=tx.init(params), tx=tx)
    params = jax.tree_util.tree_map(np.asarray, params)

    def loss_fn(p):
        loss, (metrics, pred) = model.apply({"params": p}, jb[0],
                                            method=model.loss)
        return loss, (metrics, pred)

    (loss, (metrics, pred)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(state.params)
    eval_metrics, _ = jax_eval(model)({"params": state.params}, jb[3])
    step = jax_train(model, donate=False)
    losses = []
    for b in jb[:3]:
        state, m = step(state, b, None)
        losses.append(float(m["loss"]))
    return dict(params=params, loss=float(loss), pred=np.asarray(pred),
                metrics={k: np.asarray(v) for k, v in metrics.items()},
                grads=grads, losses=losses,
                final=jax.tree_util.tree_map(np.asarray, state.params),
                eval={k: np.asarray(v) for k, v in eval_metrics.items()})


def _port_state(jax_side):
    cfg = load_config(RECIPE, overrides=NARROW)
    state = create_train_state(cfg, torch.device("cpu"))
    assert (state.model.ode_solver, state.model.method,
            state.model.ode_remat) == ("scan", "dopri5", True)
    load_flax(state.model, jax_side["params"])
    return state


def _batch(video):
    return make_batch_dict(t32(video), n_in=T_IN)


def test_scan_model_matches_jax(jax_side, batches):
    state = _port_state(jax_side)
    metrics, pred = loss_and_grads(state.model, _batch(batches[0]))
    assert max_abs(pred, jax_side["pred"]) <= 1e-4
    assert abs(float(metrics["loss"]) / jax_side["loss"] - 1.0) <= 1e-5
    for stat in ("nfe", "ode_accepted", "ode_rejected", "ode_converged"):
        assert metrics[stat] == int(jax_side["metrics"][stat]), stat
    assert_grads_close(state.model, jax_side["grads"], 1e-3)


def test_three_train_steps_match_jax(jax_side, batches):
    state = _port_state(jax_side)
    step = make_train_step()
    for i, video in enumerate(batches[:3]):
        loss = float(step(state, _batch(video))["loss"])
        assert abs(loss / jax_side["losses"][i] - 1.0) <= 1e-5, i
    assert state.step == 3
    final = flax_to_torch(jax_side["final"])
    for name, p in state.model.named_parameters():
        assert rel_l2(p, final[name]) <= 1e-4, name


def test_eval_step_matches_jax(jax_side, batches):
    state = _port_state(jax_side)
    metrics, pred = make_eval_step()(state.model, _batch(batches[3]))
    assert not pred.requires_grad
    for k in ("mse", "psnr", "ssim"):
        np.testing.assert_allclose(np32(metrics[k]), jax_side["eval"][k],
                                   rtol=1e-5, atol=1e-5)
    for k in ("nfe", "ode_accepted", "ode_rejected", "ode_converged"):
        assert metrics[f"aux_{k}"] == int(jax_side["eval"][f"aux_{k}"]), k


def _narrow_argv(corpus, logdir):
    return ["--device", "cpu", "--data_dir", str(corpus), "--logdir",
            str(logdir), "--conv_encoder_out_ch", "16",
            "--neural_ode_decoder_out_ch", "16", "--neural_ode_n_units",
            "16", "--batch_size", "2", "--quiet", "True"]


def test_main_trains_tests_and_resumes(corpus, tmp_path):
    argv = _narrow_argv(corpus, tmp_path) + [
        "--train_in_seq", "3", "--train_out_seq", "3", "--steps_per_epoch",
        "2", "--loss_log_freq", "1", "--ckpt_save_freq", "1"]
    out = main(["--configs", *RECIPE, *argv, "--epochs", "1"])
    assert out["final_step"] == 2 and np.isfinite(out["loss"])
    run = tmp_path / "ODEConv" / "ODEConv_mmnist_train_3_3"
    ckpts = sorted(p.name for p in (run / "checkpoints").glob("*.ckpt"))
    assert ckpts == ["train_mmnist_odecgru_len20_1ch_0000000001.ckpt",
                     "train_mmnist_odecgru_len20_1ch_0000000002.ckpt"]

    # A second run with one more epoch resumes at step 2.
    out = main(["--configs", *RECIPE, *argv, "--epochs", "2"])
    assert out["final_step"] == 4
    logged = [json.loads(line)["step"] for line in
              (run / "metrics.jsonl").read_text().splitlines()]
    assert logged == [1, 2, 3, 4]

    # The test block restores the newest checkpoint by ckpt_id, with the
    # train run's widths, and evaluates 3 -> 7 frames.
    out = main(["--configs", "defaults", "test_mmnist_odecgru_len20_1ch",
                *_narrow_argv(corpus, tmp_path), "--eval_batches", "2",
                "--test_in_seq", "3", "--test_out_seq", "7"])
    per_horizon = json.loads(
        (tmp_path / "ODEConv" / "ODEConv_mmnist_test_3_7"
         / "per_horizon.json").read_text())
    assert set(per_horizon) == {"mse", "psnr", "ssim"}
    for k, v in per_horizon.items():
        assert len(v) == 7 and np.all(np.isfinite(v)), k
        assert out[f"final_{k}"] == v[-1]


def test_main_defaults_to_cuda_and_refuses_the_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--configs", *RECIPE])


def test_registry_refuses_unported_families_and_options():
    from ode_rl_torch.models.registry import build_model
    from ode_rl_torch.parallel import make_mesh

    cfg = load_config(RECIPE, overrides=NARROW)
    gen = torch.Generator().manual_seed(0)
    for overrides, match in (({"mem": True, "mem_mode": "nru3"}, "nru"),
                             ({"model": "NoSuchModel"}, "not implemented")):
        with pytest.raises(NotImplementedError, match=match):
            build_model(cfg.replace(**overrides), torch.device("cpu"), gen)
    with pytest.raises(NotImplementedError, match="optimizer 'sgd'"):
        create_train_state(cfg.replace(optimizer="sgd"), torch.device("cpu"))
    # Every axis is ported (parallel/); a 'model' line of two needs a
    # process group, as JAX's make_mesh(n_model=2) needs two devices.
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(n_model=2)


@pytest.mark.parametrize("overrides,match", [
    ({"gan": True, "use_mesh": True}, "mesh"),
    ({"use_mesh": True}, "mesh")])
def test_loop_refuses_unported_options(tmp_path, monkeypatch, overrides,
                                       match):
    """``use_mesh`` trains data-parallel (parallel/mesh.py). The GAN path
    returns before the mesh is built, as JAX's does; a mesh whose ranks
    do not split the global batch is refused before anything is
    written."""
    from ode_rl_torch.parallel import Mesh
    from ode_rl_torch.train import loop

    cfg = load_config(RECIPE, overrides=NARROW).replace(**overrides)
    if cfg.get("gan", False):
        monkeypatch.setattr(loop, "train_gan", lambda *a: {"path": "gan"})
        monkeypatch.setattr(loop, "make_mesh", None)
        assert loop.train(cfg, torch.device("cpu"), logdir=tmp_path) == {
            "path": "gan"}
    else:
        monkeypatch.setattr(loop, "make_mesh",
                            lambda **kw: Mesh(rank=0, world=3))
        with pytest.raises(ValueError, match="does not split over 3 ranks"):
            loop.train(cfg, torch.device("cpu"), logdir=tmp_path)
    assert not list(tmp_path.iterdir())


def test_test_phase_refuses_lpips(tmp_path):
    """LPIPS named to load weights from a file that is missing: the test
    phase refuses rather than score with random features."""
    from ode_rl_torch.train.loop import test

    cfg = load_config(["defaults", "test_mmnist_odecgru_len20_1ch"],
                      overrides={"load_model": False, "eval_lpips": True,
                                 "lpips_alexnet_npz": str(
                                     tmp_path / "missing.npz")})
    with pytest.raises(FileNotFoundError, match="lpips_alexnet_npz"):
        test(cfg, torch.device("cpu"), logdir=tmp_path)
