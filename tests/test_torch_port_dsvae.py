"""The Sprites DS-VAE in the port against the JAX package.

* The renderer: JAX's ``sprites_batch`` videos, with the (colour,
  action, phase) JAX drew from its key recomputed from that key, against
  the port's ``render_sprites`` of the same labels, bit for bit (the
  draws themselves are the generator's and differ);
* ``SpritesLoader``'s ``.npy`` branch against JAX's on the same files,
  and the ``sprites`` branch of ``parse_datasets``;
* ``DisentangledVAE`` narrowed (f_dim 16, z_dim 8, g_dim 16, rnn_size 16;
  the DCGAN nets keep JAX's nf 64; B=2, 8 frames of 64x64x3) from JAX's
  init (``convert.py`` with the port's module: the DCGAN transposed convs
  ``d1``-``d5`` flipped by their type, the LSTM cells by name) with JAX's
  draws replayed (tests/test_torch_port_s2vae.py): the reconstruction
  to 1e-4 max abs, the loss and its terms to 1e-5 relative and the
  BatchNorm buffers to 1e-5 relative L2 in fp32, every gradient leaf in
  fp64 on both sides to 1e-6 of its norm plus 1e-9 of the whole norm;
  the motion heads' logits to 1e-5 max abs;
* ``ode_rl_torch.main`` on ``train_sprite_dsvae`` (narrowed): train,
  resume, and ``--phase test`` from the checkpoint.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import max_abs, np32, t32
from test_torch_port_s2vae import (SlotRecorder, configs, load_port,
                                   model_parity)
from test_torch_port_s3vae import Replay
from ode_rl_torch.main import main
from ode_rl_torch.models.registry import build_model
from ode_rl_torch.sprite.data import SpritesLoader, render_sprites

NARROW = {"f_dim": 16, "z_dim": 8, "g_dim": 16, "rnn_size": 16}


def test_render_matches_jax_bit_for_bit():
    from ode_rl_tpu.sprite.data import N_ACTIONS, N_COLORS, sprites_batch

    for seed, n_frames in ((0, 8), (1, 13), (2, 20)):
        key = jax.random.key(seed)
        video, actions, colors = sprites_batch(key, 16, n_frames)
        k1, k2, k3 = jax.random.split(key, 3)
        phase = jax.random.uniform(k3, (16,)) * 2 * jnp.pi
        assert np.array_equal(np.asarray(colors), np.asarray(
            jax.random.randint(k1, (16,), 0, N_COLORS)))
        ours = render_sprites(torch.from_numpy(np.asarray(colors)),
                              torch.from_numpy(np.asarray(actions)),
                              torch.from_numpy(np.asarray(phase)), n_frames)
        assert np.array_equal(np32(ours - 0.5), np.asarray(video))
        assert set(np.asarray(actions).tolist()) <= set(range(N_ACTIONS))


def test_loader_npy_branch_and_parse_datasets(tmp_path):
    from ode_rl_tpu.sprite.data import SpritesLoader as JaxLoader
    from ode_rl_torch.core.config import load_config
    from ode_rl_torch.data.mmnist import parse_datasets

    rng = np.random.RandomState(0)
    np.save(tmp_path / "sprites_clips.npy",
            rng.rand(5, 8, 64, 64, 3).astype(np.float32))
    np.save(tmp_path / "sprites_labels.npy", rng.randint(0, 6, (5, 2)))
    ours, ref = (SpritesLoader(3, data_dir=str(tmp_path)),
                 JaxLoader(3, data_dir=str(tmp_path)))
    for _ in range(3):   # wraps around the five clips
        for a, b in zip(next(ours), next(ref)):
            assert np.array_equal(np.asarray(a), np.asarray(b))

    cfg = load_config(["defaults", "train_sprite_dsvae"],
                      overrides={"batch_size": 4})
    loaders = parse_datasets(cfg, torch.device("cpu"))
    video = next(loaders["train_dataloader"])
    assert tuple(video.shape) == (4, 8, 64, 64, 3)
    assert float(video.min()) == -0.5 and float(video.max()) <= 0.5
    assert loaders["n_train_batches"] == 2000
    # The test stream has its own seed.
    assert not torch.equal(next(loaders["test_dataloader"]), video)


def test_dsvae_matches_jax():
    jcfg, cfg = configs("train_sprite_dsvae", 8, batch_size=2,
                        train_out_seq=0, **NARROW)
    rng = np.random.RandomState(0)
    v = (rng.rand(2, 8, 64, 64, 3) - 0.5).astype(np.float32)
    port = model_parity(jcfg, cfg, v, 8, True,
                        ("loss", "recon_loss", "kl_f", "kl_z"))
    assert port.decoder.d1.weight.shape == (8 + 16, 512, 4, 4)
    names = {n for n, _ in port.named_parameters()}
    assert {"prior_ly1.if.kernel", "lstm_bwd.cell.hg.bias",
            "dir8_1.kernel"} <= names


def test_dsvae_motion_heads_match_jax():
    """The area and direction logits of the full forward (the loss does
    not read them), eval mode, JAX's draws."""
    from ode_rl_tpu.models.registry import build_model as jax_build

    jcfg, cfg = configs("train_sprite_dsvae", 8, batch_size=2,
                        train_out_seq=0, **NARROW)
    x = np.random.RandomState(1).rand(2, 8, 64, 64, 3).astype(np.float32)
    model = jax_build(jcfg)
    rngs = {"params": jax.random.key(0), "sample": jax.random.key(1)}
    variables = jax.jit(lambda v: model.init(rngs, v, train=False))(
        jnp.asarray(x))
    rec = SlotRecorder()
    with pytest.MonkeyPatch.context() as mp:
        rec.patch(mp)
        out = jax.jit(lambda v: model.apply(
            variables, v, train=False,
            rngs={"sample": jax.random.key(3)}))(jnp.asarray(x))
    port = build_model(cfg, torch.device("cpu"),
                       torch.Generator().manual_seed(0)).eval()
    load_port(port, variables)
    with torch.no_grad():
        ours = port(t32(x), Replay(rec.draws))
    assert tuple(ours["pred_dirs"].shape) == (9 * 16, 8)
    for k in ("pred_area", "pred_dirs", "z_mean_prior", "recon"):
        assert max_abs(ours[k], out[k]) <= 1e-5, k


def test_main_dsvae_train_resume_test(tmp_path):
    narrow = ["--device", "cpu", "--logdir", str(tmp_path), "--batch_size",
              "2", "--epochs", "1", "--loss_log_freq", "1", "--data_dir",
              str(tmp_path / "none")]
    for name, value in NARROW.items():
        narrow += [f"--{name}", str(value)]
    out = main(["--configs", "defaults", "train_sprite_dsvae", *narrow,
                "--steps_per_epoch", "2"])
    assert out["final_step"] == 2 and np.isfinite(out["loss"])
    out = main(["--configs", "defaults", "train_sprite_dsvae", *narrow,
                "--steps_per_epoch", "3"])
    assert out["final_step"] == 3
    run = tmp_path / "DSVAE" / "DSVAE_sprite_train_8_0"
    keys = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    assert {"kl_f", "kl_z", "recon_loss", "grad_norm"} <= set(keys)
    main(["--configs", "defaults", "train_sprite_dsvae", *narrow,
          "--phase", "test", "--load_model", "True", "--eval_batches", "1"])
    per_horizon = json.loads((run / "per_horizon.json").read_text())
    for k in ("mse", "psnr", "ssim"):
        assert len(per_horizon[k]) == 8 and np.all(np.isfinite(
            per_horizon[k]))
