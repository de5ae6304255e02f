"""The port's three disentanglement commands, end to end on the CPU at a
tiny size, from checkpoints the port's ``main`` writes.

* ``python -m ode_rl_torch.mmnist_disentangle`` on two narrowed S3VAE
  runs (``train_mmnist_recon_s3vae``, one digit, 16 sprites, 64x64
  frames, 3 -> 3, one step each; the second with l1 = l2 = l3 = 0),
  judge and probes cut by its flags and their batches by their
  functions' arguments: its report has the keys, at every
  level, of the report JAX's ``scripts/mmnist_disentangle.py`` writes
  (run here with its checkpoint restore and judge training replaced by
  stand-ins and its probes cut as the port's, so that only the key
  structure is its own), every accuracy
  in [0, 1]. The swaps decode in training mode, as JAX's; the port's
  ``eval_swaps`` and ``latent_probes`` leave every BatchNorm buffer bit
  for bit as it was over two batches, where ``predict`` in training mode
  alone moves them.
* ``python -m ode_rl_torch.sprite_probe_grids`` on a narrowed
  ``train_sprite_dsvae`` run: six filmstrips of 2 inputs over 2 outputs,
  8 frames each (decoded with zlib). ``python -m
  ode_rl_torch.sprite_disagreement``: the keys of JAX's script (its
  sweeps and report dicts read from its source, the scores' keys from
  JAX's ``disagreement_scores``), finite scores, accuracies in [0, 1],
  and the clips reach the encoder in [-0.5, 0.5] as in JAX's script.
"""

import ast
import functools
import importlib.util
import json
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import decode_png
from ode_rl_torch import (mmnist_disentangle, sprite_disagreement,
                          sprite_probe_grids)
from ode_rl_torch.data.mmnist import generate_moving_mnist_labeled
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.data.sprites import get_sprite_bank
from ode_rl_torch.main import main
from ode_rl_torch.sprite.dsvae import DisentangledVAE
from ode_rl_torch.train.step import restore_model

REPO = pathlib.Path(__file__).resolve().parents[1]
S3VAE_ARGV = ["--configs", "defaults", "train_mmnist_recon_s3vae",
              "--device", "cpu", "--num_digits", "1", "--num_sprites", "16",
              "--encoder_out_dims", "16", "--d_zf", "8", "--d_zt", "8",
              "--batch_size", "2", "--train_in_seq", "3", "--train_out_seq",
              "3", "--steps_per_epoch", "1", "--epochs", "1", "--quiet",
              "True"]
CUT = ["--judge_steps", "2", "--eval_batches", "1", "--probe_train_batches",
       "2", "--probe_eval_batches", "1", "--probe_steps", "3"]


@pytest.fixture(scope="module")
def s3vae_logs(tmp_path_factory):
    logs = tmp_path_factory.mktemp("s3vae_logs")
    main([*S3VAE_ARGV, "--logdir", str(logs), "--id", "full", "--ckpt_id",
          "full"])
    main([*S3VAE_ARGV, "--logdir", str(logs), "--id", "abl", "--ckpt_id",
          "abl", "--l1", "0", "--l2", "0", "--l3", "0"])
    return logs


def _keys(tree):
    """The nested key structure of a JSON report."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _StubS3VAE:
    """Stands in for JAX's restored S3VAE: ``apply`` of ``predict`` with
    the observed frames as the decodes and constant latents."""

    predict = "predict"

    def apply(self, variables, bd, train, method, rngs, mutable,
              swap=False):
        x = bd["observed_data"] + 0.5
        b, t = x.shape[:2]
        aux = {"mu_zf": jnp.zeros((b, 8)) + x.mean(),
               "mu_zt": jnp.zeros((b, t, 8)) + x.mean(axis=(2, 3, 4))[
                   ..., None]}
        if swap:
            aux.update(x_swap_motion=x, x_swap_content=x)
        return (x, aux), {}


def _jax_report(tmp_path, monkeypatch) -> dict:
    """The report of JAX's script with its restore and judge training
    replaced by stand-ins."""
    from ode_rl_tpu.eval_models.mmnist_judge import MMNISTJudge

    script = _load_script("mmnist_disentangle")
    judge = MMNISTJudge(n_sprites=16)
    video = jnp.zeros((2, 4, 64, 64, 1))
    labels = jnp.zeros((2,), jnp.int32)
    jparams = judge.init(jax.random.key(1), video, labels, labels, labels,
                         method=judge.loss)["params"]
    _, final = judge.apply({"params": jparams}, video, labels, labels,
                           labels, method=judge.loss)
    monkeypatch.setattr(script, "train_judge", lambda bank, steps: (
        judge, jparams, {k: float(v) for k, v in final.items()}))
    cfg = types.SimpleNamespace(train_in_seq=3, train_out_seq=3,
                                get=lambda k: {"l1": 1.0, "l2": 1.0,
                                               "l3": 1.0}[k])
    monkeypatch.setattr(script, "restore_s3vae",
                        lambda ckpt_id: (_StubS3VAE(), cfg, {}))
    # Its probes at the port's cut sizes (they are the function's own
    # arguments; the script passes its defaults).
    monkeypatch.setattr(script, "latent_probes", functools.partial(
        script.latent_probes, n_train_batches=2, n_eval_batches=1,
        batch=8, probe_steps=3))
    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["mmnist_disentangle.py",
                                      "--eval_batches", "1", "--out",
                                      str(out)])
    script.main()
    return json.loads(out.read_text())


def test_mmnist_disentangle_report_has_jax_keys(s3vae_logs, tmp_path,
                                                monkeypatch):
    # The batches of its judge, swaps and probes cut by their functions'
    # own arguments (the script passes their defaults).
    for name, cut in (("train_judge", dict(batch=8, n_frames=6)),
                      ("eval_swaps", dict(batch=4)),
                      ("latent_probes", dict(batch=8))):
        monkeypatch.setattr(mmnist_disentangle, name, functools.partial(
            getattr(mmnist_disentangle, name), **cut))
    out = tmp_path / "port.json"
    report = mmnist_disentangle.main([
        "--ckpt_full", "full", "--ckpt_abl", "abl", "--logdir",
        str(s3vae_logs), "--out", str(out), "--device", "cpu", *CUT])
    assert json.loads(out.read_text()) == report
    assert _keys(report) == _keys(_jax_report(tmp_path, monkeypatch))
    assert report["n_sprites"] == 16
    assert report["models"]["ablation_l123_0"]["loss_weights"] == {
        "l1": 0.0, "l2": 0.0, "l3": 0.0}
    for row in report["models"].values():
        accs = [row["real"], row["recon"], row["swapm_motion_donor"],
                row["swapc_motion_own"]]
        assert all(0.0 <= v <= 1.0 for a in accs for v in a.values())
        assert all(0.0 <= row["latent_probes"][k] <= 1.0 for k in (
            "identity_from_zf", "identity_from_zt", "motion_from_zf",
            "motion_from_zt"))


def test_swaps_and_probes_leave_batchnorm_as_found(s3vae_logs):
    model, cfg, _ = restore_model(s3vae_logs, "S3VAE", "full",
                                  torch.device("cpu"))
    before = {k: v.clone() for k, v in model.named_buffers()}
    assert any("bn" in k for k in before)
    bank = torch.from_numpy(get_sprite_bank()[:16]).float()
    judge, _ = mmnist_disentangle.train_judge(bank, 1, batch=4, n_frames=6)
    mmnist_disentangle.eval_swaps(model, cfg, judge, bank, n_batches=2,
                                  batch=4)
    mmnist_disentangle.latent_probes(model, cfg, bank, n_train_batches=1,
                                     n_eval_batches=1, batch=4,
                                     probe_steps=1)
    for k, v in model.named_buffers():
        assert torch.equal(v, before[k]), k
    # predict in training mode without the guard moves them.
    video, _, _ = generate_moving_mnist_labeled(
        torch.Generator().manual_seed(0), bank, 4, 6)
    with torch.no_grad():
        model.predict(make_batch_dict(video, n_in=3, with_flow_labels=True),
                      torch.Generator().manual_seed(0), train=True,
                      swap=True)
    assert any(not torch.equal(v, before[k])
               for k, v in model.named_buffers())


@pytest.fixture(scope="module")
def dsvae_logs(tmp_path_factory):
    logs = tmp_path_factory.mktemp("dsvae_logs")
    main(["--configs", "defaults", "train_sprite_dsvae", "--device", "cpu",
          "--logdir", str(logs), "--batch_size", "2", "--epochs", "1",
          "--steps_per_epoch", "1", "--f_dim", "16", "--z_dim", "8",
          "--g_dim", "16", "--rnn_size", "16", "--quiet", "True",
          "--data_dir", str(logs / "none")])
    return logs


def test_sprite_probe_grids_write_six_filmstrips(dsvae_logs, tmp_path):
    paths = sprite_probe_grids.main(["--logdir", str(dsvae_logs), "--out",
                                     str(tmp_path / "grids"), "--device",
                                     "cpu"])
    assert [p.name for p in paths] == [f"{probe}.png" for probe in
                                       sprite_probe_grids.PROBES]
    assert len(paths) == 6
    for path in paths:
        assert decode_png(path).shape == (4 * 64, 8 * 64, 3)


def _dict_keys(source: str):
    """The string keys of each dict literal of the source (a ``**``
    entry has none)."""
    return [{k.value for k in node.keys if isinstance(k, ast.Constant)}
            for node in ast.walk(ast.parse(source))
            if isinstance(node, ast.Dict)]


def test_sprite_disagreement_report_has_jax_keys(dsvae_logs, tmp_path,
                                                 monkeypatch):
    from ode_rl_tpu.sprite.disagreement import disagreement_scores

    seen = []
    encode = DisentangledVAE.encode_and_sample_post

    def recording(self, x, train, noise):
        seen.append(float(x.min()))
        return encode(self, x, train, noise)

    monkeypatch.setattr(DisentangledVAE, "encode_and_sample_post", recording)
    out = tmp_path / "d.json"
    report = sprite_disagreement.main([
        "--logdir", str(dsvae_logs), "--steps", "2", "--batches", "1",
        "--batch_size", "8", "--out", str(out), "--device", "cpu"])
    assert json.loads(out.read_text()) == report
    assert seen[0] == -0.5     # real clips, as JAX's script passes them
    dicts = _dict_keys((REPO / "scripts" / "sprite_disagreement.py")
                       .read_text())
    sweeps = {"fixed_action_resampled_content",
              "fixed_content_resampled_motion"}
    assert sweeps in dicts and {"ckpt_step", "judge_steps"} in dicts
    assert set(report) == sweeps | {"ckpt_step", "judge_steps"}
    p = np.full((4, 4), 0.25)
    score_keys = set(disagreement_scores(p, p, np.arange(4)))
    for name in sweeps:
        assert set(report[name]) == score_keys
        assert all(np.isfinite(v) for v in report[name].values())
        assert 0.0 <= report[name]["acc"] <= 1.0
    assert report["ckpt_step"] == 1 and report["judge_steps"] == 2
