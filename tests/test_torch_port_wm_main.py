"""The world-model blocks through the port's entry point on the CPU.

``ode_rl_torch.main`` on ``train_mmnist_dreamer``,
``train_mmnist_dreamer_discrete`` and ``train_mmnist_dreamer_spatial``,
narrowed (B=2, 3 -> 2 frames; depth 4, stoch 4, deter and hidden 16;
the spatial model's channels 4 and 8): 2 steps, a resume to 3, and the
test phase from the checkpoint (3 -> 4 frames, one batch, finite
per-horizon metrics). Then ``train_cater_classifier`` on a corpus of 4 +
4 episodes of 8 frames that it writes itself (chunks of 4 frames,
classifier width 8), 2 steps, and ``test_cater_classifier`` from its
checkpoint. ``python -m ode_rl_torch.rl_demo`` a few steps on the CPU.
"""

import json

import numpy as np
import pytest

from ode_rl_torch import rl_demo
from ode_rl_torch.main import main

DREAMER = ["--cnn_depth", "4", "--dyn_stoch", "4", "--dyn_deter", "16",
           "--dyn_hidden", "16"]
SPATIAL = ["--dyn_stoch_ch", "4", "--dyn_deter_ch", "8", "--dyn_hidden_ch",
           "8", "--embed_ch", "8"]
BLOCKS = [("train_mmnist_dreamer", "Dreamer", DREAMER),
          ("train_mmnist_dreamer_discrete", "Dreamer", DREAMER),
          ("train_mmnist_dreamer_spatial", "SpatialDreamer", SPATIAL)]


@pytest.mark.parametrize("block,model,narrow", BLOCKS,
                         ids=[b[0] for b in BLOCKS])
def test_main_world_model_train_resume_test(tmp_path, block, model, narrow):
    common = ["--configs", "defaults", block, "--device", "cpu", "--logdir",
              str(tmp_path), "--batch_size", "2", *narrow]
    train = [*common, "--train_in_seq", "3", "--train_out_seq", "2",
             "--epochs", "1", "--loss_log_freq", "1"]
    out = main([*train, "--steps_per_epoch", "2"])
    assert out["final_step"] == 2 and np.isfinite(out["loss"])
    out = main([*train, "--steps_per_epoch", "3"])
    assert out["final_step"] == 3
    runs = list((tmp_path / model).iterdir())
    assert len(runs) == 1
    logged = [json.loads(line) for line in
              (runs[0] / "metrics.jsonl").read_text().splitlines()]
    keys = ({"kl", "kl_loss", "image_loss", "prior_ent", "post_ent"}
            if model == "Dreamer" else
            {"kl_loss", "image_loss", "gate_mean", "sparsity_loss"})
    for m in logged:
        if "loss" in m:
            assert keys | {"loss", "grad_norm"} <= set(m)
            assert all(np.isfinite(m[k]) for k in keys | {"grad_norm"})
    assert [m["step"] for m in logged if "loss" in m] == [1, 2, 3]
    out = main([*common, "--phase", "test", "--load_model", "True",
                "--eval_batches", "1", "--test_in_seq", "3",
                "--test_out_seq", "4"])
    for k in ("mse", "psnr", "ssim"):
        assert len(out["per_horizon"][k]) == 4
        assert np.all(np.isfinite(out["per_horizon"][k]))


def test_main_cater_classifier_train_then_test(tmp_path):
    data = tmp_path / "cater"
    common = ["--device", "cpu", "--logdir", str(tmp_path), "--data_dir",
              str(data), "--batch_size", "2"]
    out = main(["--configs", "defaults", "train_cater_classifier", *common,
                *DREAMER, "--classifier_units", "8", "--cater_train", "4",
                "--cater_val", "4", "--cater_frames", "8", "--batch_length",
                "4", "--epochs", "1", "--steps_per_epoch", "2",
                "--loss_log_freq", "1"])
    assert out["steps"] == 2
    assert len(list((data / "videos").iterdir())) == 8
    for k in ("val_mAP", "val_top5", "random_mAP_baseline",
              "val_mAP_reference_metric"):
        assert np.isfinite(out[k]) and 0.0 <= out[k] <= 1.0, k
    run = tmp_path / "CATER" / "CATER_classifier_train"
    logged = [json.loads(line) for line in
              (run / "metrics.jsonl").read_text().splitlines()]
    assert {"loss", "wm_loss", "classifier_loss", "mAP", "top5"} <= set(
        logged[0])
    assert json.loads((run / "cater_eval.json").read_text())["steps"] == 2
    # The test block builds the model from the saved (narrowed) config.
    test = main(["--configs", "defaults", "test_cater_classifier",
                 *common])
    assert test["ckpt_step"] == 2
    for k in ("val_mAP", "val_top5", "random_mAP_baseline"):
        assert test[k] == pytest.approx(out[k], abs=0.5)
        assert np.isfinite(test[k])
    assert (run / "cater_eval_test_phase.json").exists()


def test_rl_demo_runs_on_the_cpu(tmp_path):
    report = rl_demo.main([
        "--device", "cpu", "--wm_steps", "2", "--behavior_steps", "2",
        "--batch", "2", "--episode_len", "4", "--horizon", "3",
        "--eval_episodes", "3", "--eval_len", "3", "--report",
        str(tmp_path / "rl.json")])
    saved = json.loads((tmp_path / "rl.json").read_text())
    assert saved["device"] == "cpu" and saved["wm_steps"] == 2
    for k in ("eval_mean_reward_actor", "eval_mean_reward_random",
              "imag_reward_final"):
        assert np.isfinite(saved[k]) and saved[k] == report[k]
    assert {"loss", "image_loss", "reward_loss", "kl"} <= set(
        saved["wm_final"])
    assert rl_demo.parse_args([]).report == "results/torch/dreamer_rl.json"
