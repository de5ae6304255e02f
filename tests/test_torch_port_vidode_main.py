"""The four Moving MNIST Vid-ODE blocks through the port's entry point
on the CPU (``ode_rl_torch.main``, ``--device cpu``), narrowed to batch
2 and 3 -> 3 frames at the blocks' own widths: ``len20``, ``irregular``
(window sampling with observation masks) and ``slots`` train two steps,
resume to four from the checkpoint, and test 3 -> 3 from it; ``gan``
trains two epochs of one step with its periodic evaluation (four test
batches) each epoch (no resume, as JAX's GAN loop has none) and tests from its generator's
checkpoint. Each logged loss (and grad_norm, or the GAN's D and G
losses) is finite, the BatchNorm buffers in the checkpoint moved, the
test writes finite per-horizon MSE/PSNR/SSIM and ``lpips_uncalibrated``
and a PNG sheet, and TF32 is off after ``main``.
"""

import json

import numpy as np
import pytest
import torch

from torch_port_util import decode_png
from ode_rl_torch.core.checkpoint import CheckpointManager
from ode_rl_torch.main import main

NARROW = ["--device", "cpu", "--batch_size", "2", "--train_in_seq", "3",
          "--train_out_seq", "3", "--test_in_seq", "3", "--test_out_seq",
          "3", "--loss_log_freq", "1", "--quiet", "True"]
PER_HORIZON = {"mse", "psnr", "ssim", "lpips_uncalibrated"}


def logged(run) -> list:
    return [json.loads(line)
            for line in (run / "metrics.jsonl").read_text().splitlines()]


def assert_bn_moved(snapshot_model: dict) -> None:
    bn = {k: v for k, v in snapshot_model.items()
          if k.endswith((".mean", ".var"))}
    assert bn and all(
        not torch.all(v == (0.0 if k.endswith(".mean") else 1.0))
        for k, v in bn.items())


def run_test_phase(block: str, logs, extra=()) -> dict:
    out = main(["--configs", "defaults", block, *NARROW, "--phase", "test",
                "--load_model", "True", "--eval_batches", "1",
                "--logdir", str(logs), *extra])
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    run = next(p for p in (logs / "VidODE").iterdir()
               if (p / "per_horizon.json").exists())
    per_horizon = json.loads((run / "per_horizon.json").read_text())
    assert set(per_horizon) == PER_HORIZON
    for k, v in per_horizon.items():
        assert len(v) == 3 and np.all(np.isfinite(v)), k
        assert out[f"final_{k}"] == v[-1]
    sheet = decode_png(run / "pred_gt.png")
    assert sheet.shape == (2 * 64, 3 * 64, 3)
    return out


@pytest.mark.parametrize("block", ["train_mmnist_vidode_len20",
                                   "train_mmnist_vidode_irregular",
                                   "train_mmnist_vidode_slots"])
def test_main_trains_resumes_and_tests(block, tmp_path, capsys):
    argv = ["--configs", "defaults", block, *NARROW, "--steps_per_epoch",
            "2", "--logdir", str(tmp_path)]
    out = main([*argv, "--epochs", "1"])
    assert out["final_step"] == 2
    out = main([*argv, "--epochs", "2"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert out["final_step"] == 4
    run = next((tmp_path / "VidODE").iterdir())
    metrics = logged(run)
    assert [m["step"] for m in metrics] == [1, 2, 3, 4]
    for m in metrics:
        for k in ("loss", "recon_l1", "diff_l1", "grad_norm", "nfe"):
            assert np.isfinite(m[k]), (m["step"], k)
    ckpt = CheckpointManager(run / "checkpoints", tag=block)
    assert ckpt.all_steps() == [2, 4]
    assert_bn_moved(ckpt.restore({"model": {}})["state"]["model"])
    run_test_phase(block, tmp_path)


def test_main_gan_trains_evaluates_and_tests(tmp_path):
    block = "train_mmnist_vidode_gan"
    out = main(["--configs", "defaults", block, *NARROW, "--steps_per_epoch",
                "1", "--epochs", "2", "--gan_test_freq_epochs", "1",
                "--logdir", str(tmp_path)])
    assert out["final_step"] == 2
    assert out["lr"] == pytest.approx(8e-4 * 0.99, rel=1e-9)
    run = next((tmp_path / "VidODE").iterdir())
    steps = [m for m in logged(run) if "d_loss" in m]
    assert [m["step"] for m in steps] == [1, 2]
    for m in steps:
        for k in ("loss", "d_loss", "g_loss", "g_adv_loss"):
            assert np.isfinite(m[k]), (m["step"], k)
    for epoch in (1, 2):
        assert (run / f"test_epoch{epoch:05d}.png").exists()
        curves = json.loads((run / f"gan_eval_epoch{epoch:05d}.json")
                            .read_text())
        assert np.all(np.isfinite(curves["mse"]))
    saved = CheckpointManager(run / "checkpoints", tag=block).restore(
        {"gen_params": {}, "gen_model_state": {}, "disc_params": {}})
    assert saved["step"] == 2
    assert_bn_moved(saved["state"]["gen_model_state"])
    assert "seq.l1.weight" in saved["state"]["disc_params"]
    run_test_phase(block, tmp_path)
