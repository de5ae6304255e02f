"""The port's Vid-ODE corpus commands against the JAX repo's scripts:
``python -m ode_rl_torch.make_synthetic_corpus`` against
``scripts/make_synthetic_corpus.py`` on each of the six datasets, and
``python -m ode_rl_torch.generate_phyre_dataset`` against
``scripts/generate_phyre_dataset.py --synthetic``, at the same flags:
the same file names and every file byte-equal. The scripts run as their
users run them, in a subprocess; the port's commands in this process,
and once each through ``python -m`` with their defaults. The digests
``chip_smoke.py`` holds the card's corpora to are the scripts'.
"""

import ast
import hashlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from ode_rl_torch import generate_phyre_dataset, make_synthetic_corpus
from ode_rl_torch.data.video_corpus import RAW_SPECS

REPO = pathlib.Path(__file__).resolve().parents[1]
FEW = ["--train_videos", "2", "--test_videos", "1"]


def run(args, cwd) -> str:
    """A command in a subprocess from ``cwd``, with the repo importable."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")])}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          check=True, capture_output=True, text=True).stdout


def assert_same_files(ours: pathlib.Path, theirs: pathlib.Path) -> int:
    """Both trees hold the same .npy names with the same bytes; returns
    how many."""
    names = sorted(p.relative_to(theirs) for p in theirs.rglob("*.npy"))
    assert names == sorted(p.relative_to(ours) for p in ours.rglob("*.npy"))
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    return len(names)


@pytest.mark.parametrize("dataset", sorted(RAW_SPECS))
def test_synthetic_corpus_is_the_scripts(dataset, tmp_path):
    """Seed 0, 2 train and 1 test videos: every file byte-equal (a
    float64 blob canvas moves one byte of hurricane's, phyre's and
    minerl's)."""
    run([REPO / "scripts" / "make_synthetic_corpus.py", "--dataset", dataset,
         "--out", tmp_path / "script", *FEW], tmp_path)
    digests = make_synthetic_corpus.main(["--dataset", dataset, "--out",
                                          str(tmp_path / "port"), *FEW])
    assert sorted(digests) == ["test/video_00000.npy",
                               "train/video_00000.npy",
                               "train/video_00001.npy"]
    assert assert_same_files(tmp_path / "port", tmp_path / "script") == 3


def test_phyre_rollouts_are_the_scripts(tmp_path):
    """The script's synthetic branch at seed 1 and 12 frames: every
    rollout byte-equal."""
    flags = [*FEW, "--frames", "12", "--seed", "1"]
    run([REPO / "scripts" / "generate_phyre_dataset.py", "--synthetic",
         "--out", tmp_path / "script", *flags], tmp_path)
    generate_phyre_dataset.main(["--synthetic", "--out",
                                 str(tmp_path / "port"), *flags])
    assert assert_same_files(tmp_path / "port", tmp_path / "script") == 3


def test_commands_take_the_scripts_defaults(tmp_path):
    """Through ``python -m`` with no --out, --seed or --frames: the
    scripts' defaults (datasets/<dataset>, seed 0, 40 frames), the same
    bytes; the video counts default to 40 and 8; the PHYRE command says
    in its --help that it writes synthetic rollouts only."""
    for who, base in (("script", tmp_path / "s"), ("port", tmp_path / "p")):
        base.mkdir()
        for command in (("make_synthetic_corpus.py", "--dataset", "mgif"),
                        ("generate_phyre_dataset.py", "--synthetic")):
            script, *flags = command
            head = ([REPO / "scripts" / script] if who == "script" else
                    ["-m", f"ode_rl_torch.{script[:-3]}"])
            run([*head, *flags, "--train_videos", "1", "--test_videos", "1"],
                base)
    assert assert_same_files(tmp_path / "p" / "datasets",
                             tmp_path / "s" / "datasets") == 4
    args = make_synthetic_corpus.parse_args(["--dataset", "kth"])
    assert (args.out, args.train_videos, args.test_videos, args.seed) == (
        None, 40, 8, 0)
    args = generate_phyre_dataset.parse_args([])
    assert (args.out, args.train_videos, args.test_videos, args.frames,
            args.seed) == ("datasets/phyre", 40, 8, 40, 0)
    assert "always writes synthetic rollouts" in " ".join(run(
        ["-m", "ode_rl_torch.generate_phyre_dataset", "--help"],
        tmp_path).split())


def _chip_smoke_constant(name: str):
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name):
            return ast.literal_eval(node.value)
    raise KeyError(name)


@pytest.mark.parametrize("dataset", _chip_smoke_constant("VIDODE_CORPORA"))
def test_chip_smoke_digests_are_the_scripts(dataset, tmp_path):
    """``VIDODE_CORPUS_BYTES``: the sha256 and the byte sums of each file
    the scripts write with chip_smoke's flags."""
    flags = _chip_smoke_constant("VIDODE_CORPUS_FLAGS")
    head = (["generate_phyre_dataset.py",
             *_chip_smoke_constant("VIDODE_PHYRE_FLAGS")]
            if dataset == "phyre" else
            ["make_synthetic_corpus.py", "--dataset", dataset])
    run([REPO / "scripts" / head[0], *head[1:], "--out", tmp_path, *flags],
        tmp_path)
    want = {name: value for name, value in
            _chip_smoke_constant("VIDODE_CORPUS_BYTES").items()
            if name.startswith(f"{dataset}/")}
    got = {}
    for f in sorted(tmp_path.rglob("*.npy")):
        flat = np.load(f).reshape(-1).astype(np.int64)
        got[f"{dataset}/{f.relative_to(tmp_path)}"] = (
            hashlib.sha256(f.read_bytes()).hexdigest(), int(flat.sum()),
            int(np.dot(np.arange(flat.size), flat)))
    assert len(got) == 8 and got == want
