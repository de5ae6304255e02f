"""The six Vid-ODE corpus blocks through the port's entry point on the
CPU, each on a synthetic corpus at its dataset's raw geometry that the
port's writer puts in ``tmp_path`` (data/video_corpus.py): two training
steps on 6-frame windows, sampled and split 3 -> 3 (each block's
``clip`` and ``nan_guard`` on), and the test phase 3 -> 3 from the
checkpoint; ``train_kth_vidode`` also resumes. Each logged loss and
grad_norm is finite and no step was skipped, and the test writes finite
per-horizon MSE/PSNR/SSIM and ``lpips_uncalibrated``.
"""

import json

import numpy as np
import pytest

from ode_rl_torch.main import main
from ode_rl_torch.data.video_corpus import write_synthetic_corpus

NARROW = ["--device", "cpu", "--batch_size", "2", "--window_size", "6",
          "--train_seq", "6", "--train_in_seq", "3", "--train_out_seq", "3",
          "--test_seq", "6", "--test_in_seq", "3", "--test_out_seq", "3",
          "--loss_log_freq", "1", "--quiet", "True"]


@pytest.mark.parametrize("dataset", ["kth", "mgif", "penn", "hurricane",
                                     "phyre", "minerl"])
def test_corpus_block_trains_and_tests(dataset, tmp_path, capsys):
    block = f"train_{dataset}_vidode"
    root = write_synthetic_corpus(tmp_path / dataset, dataset,
                                  train_videos=3, test_videos=2, frames=8)
    argv = ["--configs", "defaults", block, *NARROW, "--data_dir", str(root),
            "--logdir", str(tmp_path / "logs"), "--steps_per_epoch", "2"]
    assert main([*argv, "--epochs", "1"])["final_step"] == 2
    steps = 2
    if dataset == "kth":
        assert main([*argv, "--epochs", "2"])["final_step"] == 4
        assert "resumed from step 2" in capsys.readouterr().out
        steps = 4
    run = next((tmp_path / "logs" / "VidODE").iterdir())
    logged = [json.loads(line)
              for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in logged] == list(range(1, steps + 1))
    for m in logged:
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
        assert m["nan_skipped"] == 0
    out = main(["--configs", "defaults", block, *NARROW, "--data_dir",
                str(root), "--logdir", str(tmp_path / "logs"), "--phase",
                "test", "--load_model", "True", "--eval_batches", "1"])
    per_horizon = json.loads((run / "per_horizon.json").read_text())
    assert set(per_horizon) == {"mse", "psnr", "ssim", "lpips_uncalibrated"}
    for k, v in per_horizon.items():
        assert len(v) == 3 and np.all(np.isfinite(v)), k
    assert np.isfinite(out["final_lpips_uncalibrated"])
