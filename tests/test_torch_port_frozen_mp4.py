"""The reference's mp4 corpus layout in the port against the JAX package.

On a corpus of ``video_<n>.mp4`` files the test writes with cv2 from
seeded numpy frames (12 train videos of 24 to 30 frames, so that the
sorted glob's order, ``video_10`` before ``video_2``, and the cut to the
shortest video both matter; 3 test videos), the port's
``FrozenMovingMNIST``, ``read_video_file`` and ``parse_datasets`` give
JAX's batches bit for bit: train and test splits, a flat corpus serving
both, two seeds. ``python -m ode_rl_torch.make_mp4_mmnist --device cpu``
takes ``scripts/make_mp4_mmnist.py``'s flags and defaults and writes its
layout, which both loaders read to the same batches. Exact equality
throughout; the decoder is the same cv2 on both sides.
"""

import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from ode_rl_torch.core.config import Config  # noqa: E402
from ode_rl_torch.data.frozen import (FrozenMovingMNIST,  # noqa: E402
                                      read_video_file)
from ode_rl_torch.data.mmnist import parse_datasets  # noqa: E402
from ode_rl_torch import make_mp4_mmnist  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


def _write_video(path, frames: np.ndarray) -> None:
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (frames.shape[2], frames.shape[1]))
    assert w.isOpened(), path
    for f in frames:
        w.write(cv2.cvtColor(f, cv2.COLOR_GRAY2BGR))
    w.release()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """<root>/{train,test}/video_<n>.mp4 and <flat>/video_<n>.mp4 (the
    train videos). Frames are blocky noise, so mp4v keeps them apart."""
    root = tmp_path_factory.mktemp("mp4")
    rng = np.random.RandomState(0)
    for split, n in (("train", 12), ("test", 3)):
        (root / split).mkdir()
        for i in range(n):
            coarse = rng.randint(0, 256, (24 + rng.randint(7), 8, 8),
                                 dtype=np.uint8)
            frames = coarse.repeat(8, axis=1).repeat(8, axis=2)
            _write_video(root / split / f"video_{i}.mp4", frames)
    flat = tmp_path_factory.mktemp("flat")
    for p in (root / "train").glob("video_*.mp4"):
        shutil.copy(p, flat / p.name)
    return root, flat


def test_corpus_has_unequal_lengths_and_lexicographic_order(corpus):
    root, _ = corpus
    names = [p.name for p in sorted((root / "train").glob("video_*.mp4"))]
    assert names[:4] == ["video_0.mp4", "video_1.mp4", "video_10.mp4",
                         "video_11.mp4"]
    lengths = [len(read_video_file(root / "train" / n)) for n in names]
    assert min(lengths) >= 24 and len(set(lengths)) > 1


@pytest.mark.parametrize("layout,is_train,seed", [
    ("split", True, 0), ("split", False, 0), ("flat", True, 0),
    ("flat", False, 7), ("split", True, 7)])
def test_mp4_batches_bit_equal_jax(corpus, layout, is_train, seed):
    from ode_rl_tpu.data.frozen import FrozenMovingMNIST as JaxFrozen

    root = corpus[0] if layout == "split" else corpus[1]
    ours = FrozenMovingMNIST(root, 3, 4, 6, is_train=is_train, seed=seed)
    theirs = JaxFrozen(root, 3, 4, 6, is_train=is_train, seed=seed)
    np.testing.assert_array_equal(ours._mp4_shard, theirs._mp4_shard)
    for _ in range(6):
        a, b = next(ours), np.asarray(next(theirs))
        assert a.dtype == torch.float32 and tuple(a.shape) == (3, 10, 64,
                                                               64, 1)
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("gray", [True, False])
def test_read_video_file_bit_equal_jax(corpus, gray, tmp_path):
    from ode_rl_tpu.data.frozen import read_video_file as jax_read

    for name in ("video_0.mp4", "video_10.mp4"):
        path = corpus[0] / "train" / name
        np.testing.assert_array_equal(read_video_file(path, gray=gray),
                                      jax_read(path, gray=gray))
    bad = tmp_path / "video_0.mp4"
    bad.write_bytes(b"not a video at all")
    for read in (read_video_file, jax_read):
        with pytest.raises(IOError, match=f"failed to decode {bad} after 2 "
                                          "attempts"):
            read(bad, retries=2)


def _cfg(data_dir):
    return Config(dict(dataset="mmnist", batch_size=3, data_points=100,
                       train_test_split=0.8, train_in_seq=4, train_out_seq=6,
                       test_in_seq=2, test_out_seq=8, num_digits=2, seed=0,
                       data_dir=str(data_dir), frozen=True))


def _loaders_equal(root, draws: int = 3) -> None:
    from ode_rl_tpu.core.config import Config as JaxConfig
    from ode_rl_tpu.data.mmnist import parse_datasets as jax_parse

    cfg = _cfg(root)
    ours = parse_datasets(cfg, torch.device("cpu"))
    theirs = jax_parse(JaxConfig(cfg.to_dict()))
    assert ours["frozen"] is theirs["frozen"] is True
    for split in ("train_dataloader", "test_dataloader"):
        assert isinstance(ours[split], FrozenMovingMNIST)
        for _ in range(draws):
            np.testing.assert_array_equal(next(ours[split]).numpy(),
                                          np.asarray(next(theirs[split])))


@pytest.mark.parametrize("layout", ["split", "flat"])
def test_parse_datasets_frozen_mp4_bit_equal_jax(corpus, layout):
    _loaders_equal(corpus[0] if layout == "split" else corpus[1])


def _script_flags() -> tuple:
    """The flags ``scripts/make_mp4_mmnist.py --help`` prints, and the
    defaults its parser declares."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    usage = subprocess.run(
        [sys.executable, str(REPO / "scripts/make_mp4_mmnist.py"), "--help"],
        check=True, capture_output=True, text=True, env=env).stdout
    flags = set(re.findall(r"--(\w+)", usage)) - {"help"}
    defaults = {}
    tree = ast.parse((REPO / "scripts/make_mp4_mmnist.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                defaults[node.args[0].value[2:]] = ast.literal_eval(
                    kw["default"])
    return flags, defaults


def test_make_mp4_mmnist_takes_the_scripts_flags_and_writes_its_layout(
        tmp_path):
    flags, defaults = _script_flags()
    assert flags == {"out", "videos", "test_videos", "frames", "fps", "seed"}
    ours = vars(make_mp4_mmnist.parse_args(["--out", "x"]))
    assert set(ours) == flags | {"device"} and ours["device"] == "cuda"
    assert set(defaults) == flags - {"out"}
    assert {k: ours[k] for k in defaults} == defaults
    with pytest.raises(SystemExit):
        make_mp4_mmnist.parse_args([])

    out = tmp_path / "mp4"
    subprocess.run(
        [sys.executable, "-m", "ode_rl_torch.make_mp4_mmnist", "--device",
         "cpu", "--out", str(out), "--videos", "2", "--test_videos", "1",
         "--frames", "24"], check=True, capture_output=True, cwd=REPO)
    assert sorted(str(p.relative_to(out)) for p in out.rglob("*")) == [
        "test", "test/video_0.mp4", "train", "train/video_0.mp4",
        "train/video_1.mp4"]
    video = read_video_file(out / "train" / "video_0.mp4")
    assert video.shape == (24, 64, 64)
    # Digits survive the lossy codec: neither blank nor saturated.
    assert 0.001 < float((video > 127).mean()) < 0.6
    _loaders_equal(out)
