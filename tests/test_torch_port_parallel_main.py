"""``ode_rl_torch.main --use_mesh True`` at 2 gloo ranks on the CPU, as
torchrun would start it (ode_rl_torch/parallel/dryrun.py's ``run_main``:
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set, the group joined
through a ``file://`` store): the ConvGRU block on a frozen corpus,
``batch_size`` 4 the global batch (2 rows a rank), 3 steps. Its logged
losses are the one-process run's within 1e-5 relative (the ranks sum
their rows in another order), rank 0 writes the one log and the one
checkpoint, and a second run resumes from it for 3 more steps.
"""

import json

import numpy as np
import pytest

from ode_rl_torch.main import main
from ode_rl_torch.parallel.dryrun import run_main

RUN = ("ConvGRU", "ConvGRU_mmnist_train_10_10")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("frozen")
    rng = np.random.RandomState(0)
    for split, n in (("train", 4), ("test", 2)):
        (root / split).mkdir()
        np.save(root / split / "shard_0000.npy",
                rng.randint(0, 256, (n, 40, 64, 64), dtype=np.uint8))
    (root / "meta.json").write_text(json.dumps({"frames": 40}))
    return root


def _argv(corpus, logdir, epochs: int):
    return ["--configs", "defaults", "train_mmnist_cgru_len20", "--device",
            "cpu", "--data_dir", str(corpus), "--logdir", str(logdir),
            "--batch_size", "4", "--quiet", "True", "--steps_per_epoch", "3",
            "--epochs", str(epochs), "--loss_log_freq", "1",
            "--ckpt_save_freq", "100"] + [
        a for k in ("conv_encoder_out_ch", "convgru_out_ch")
        for a in (f"--{k}", "16")]


def _logged(logdir):
    path = logdir.joinpath(*RUN, "metrics.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    one = tmp_path_factory.mktemp("one")
    main(_argv(corpus, one, 1))
    two = tmp_path_factory.mktemp("two")
    first = run_main(_argv(corpus, two, 1) + ["--use_mesh", "True"], ranks=2)
    steps_after_first = [m["step"] for m in _logged(two)]
    ckpts_after_first = sorted(p.name for p in two.joinpath(
        *RUN, "checkpoints").glob("*.ckpt"))
    resumed = run_main(_argv(corpus, two, 2) + ["--use_mesh", "True"],
                       ranks=2)
    return dict(one=_logged(one), two=_logged(two), first=first,
                resumed=resumed, steps_after_first=steps_after_first,
                ckpts_after_first=ckpts_after_first, logdir=two)


def test_two_ranks_log_the_one_process_losses(runs):
    assert runs["steps_after_first"] == [1, 2, 3]
    for ours, ref in zip(runs["two"][:3], runs["one"]):
        for key in ("loss", "mse"):
            assert abs(ours[key] - ref[key]) <= 1e-5 * abs(ref[key]), key


def test_every_rank_ends_with_the_global_metrics(runs):
    first = runs["first"]
    assert [r["final_step"] for r in first] == [3, 3]
    assert first[0]["loss"] == first[1]["loss"]
    assert first[0]["grad_norm"] == first[1]["grad_norm"]


def test_rank_zero_writes_one_checkpoint(runs):
    ckpts = runs["ckpts_after_first"]
    assert len(ckpts) == 1 and ckpts[0].endswith("_0000000003.ckpt")


def test_a_second_run_resumes_from_it(runs):
    assert [r["final_step"] for r in runs["resumed"]] == [6, 6]
    assert [m["step"] for m in runs["two"]] == [1, 2, 3, 4, 5, 6]
    ckpts = sorted(p.name for p in runs["logdir"].joinpath(
        *RUN, "checkpoints").glob("*.ckpt"))
    assert [c[-15:] for c in ckpts] == ["0000000003.ckpt", "0000000006.ckpt"]
