"""The frozen Moving MNIST reader and ``parse_datasets`` of the port
against the JAX package's, on a corpus of uint8 ``.npy`` shards the test
writes: batches bit-equal over several draws, the same choice of frozen or
generated data, and equal batch counts. Exact equality throughout."""

import json

import numpy as np
import pytest
import torch

from ode_rl_torch.core.config import Config
from ode_rl_torch.data.frozen import FrozenMovingMNIST
from ode_rl_torch.data.mmnist import MovingMNIST, parse_datasets


def _write_corpus(root, frames=30, meta=True):
    rng = np.random.RandomState(0)
    for split, sizes in (("train", (5, 3)), ("test", (4,))):
        (root / split).mkdir(parents=True)
        for i, n in enumerate(sizes):
            np.save(root / split / f"shard_{i:04d}.npy",
                    rng.randint(0, 256, (n, frames, 64, 64), dtype=np.uint8))
    if meta:
        (root / "meta.json").write_text(json.dumps({"frames": frames}))
    return root


@pytest.mark.parametrize("is_train,seed", [(True, 0), (False, 0), (True, 7)])
def test_frozen_batches_bit_equal_jax(tmp_path, is_train, seed):
    from ode_rl_tpu.data.frozen import FrozenMovingMNIST as JaxFrozen

    root = _write_corpus(tmp_path)
    ours = FrozenMovingMNIST(root, 3, 4, 6, is_train=is_train, seed=seed)
    theirs = JaxFrozen(root, 3, 4, 6, is_train=is_train, seed=seed)
    for _ in range(6):
        a, b = next(ours), np.asarray(next(theirs))
        assert a.dtype == torch.float32 and tuple(a.shape) == (3, 10, 64,
                                                               64, 1)
        np.testing.assert_array_equal(a.numpy(), b)


def test_frozen_refuses_short_videos_missing_shards_and_mp4(tmp_path):
    root = _write_corpus(tmp_path / "short", frames=8)
    with pytest.raises(ValueError, match="frames"):
        next(FrozenMovingMNIST(root, 2, 4, 6))
    with pytest.raises(FileNotFoundError):
        FrozenMovingMNIST(tmp_path / "empty", 2, 4, 6)
    (tmp_path / "mp4" / "train").mkdir(parents=True)
    (tmp_path / "mp4" / "train" / "video_0.mp4").write_bytes(b"")
    # An mp4 corpus is decoded (tests/test_torch_port_frozen_mp4.py); an
    # empty file fails JAX's read-retry loop as JAX's does.
    with pytest.raises(IOError, match="failed to decode"):
        FrozenMovingMNIST(tmp_path / "mp4", 2, 4, 6)


def _cfg(data_dir, frozen, **kw):
    entries = dict(dataset="mmnist", batch_size=3, data_points=100,
                   train_test_split=0.8, train_in_seq=4, train_out_seq=6,
                   test_in_seq=2, test_out_seq=8, num_digits=2, seed=0,
                   data_dir=str(data_dir), frozen=frozen)
    entries.update(kw)
    return Config(entries)


@pytest.mark.parametrize("frozen,meta", [(True, True), (True, False),
                                         (False, True)])
def test_parse_datasets_chooses_as_jax(tmp_path, frozen, meta):
    from ode_rl_tpu.core.config import Config as JaxConfig
    from ode_rl_tpu.data.mmnist import parse_datasets as jax_parse

    root = _write_corpus(tmp_path, meta=meta)
    cfg = _cfg(root, frozen)
    ours = parse_datasets(cfg, torch.device("cpu"))
    theirs = jax_parse(JaxConfig(cfg.to_dict()))
    for k in ("n_train_batches", "n_test_batches", "frozen"):
        assert ours.get(k) == theirs.get(k), k
    assert (ours["n_train_batches"], ours["n_test_batches"]) == (26, 6)
    kind = FrozenMovingMNIST if (frozen and meta) else MovingMNIST
    for split, n in (("train_dataloader", 10), ("test_dataloader", 10)):
        loader = ours[split]
        assert isinstance(loader, kind)
        a, b = next(loader), np.asarray(next(theirs[split]))
        assert tuple(a.shape) == b.shape == (3, n, 64, 64, 1)
        if kind is FrozenMovingMNIST:
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            assert float(a.min()) >= -0.5 and float(a.max()) <= 0.5


def test_generated_streams_are_seeded_and_test_offset():
    def first(seed, is_train):
        return next(MovingMNIST(2, 3, 3, seed=seed, is_train=is_train))

    assert torch.equal(first(0, True), first(0, True))
    assert not torch.equal(first(0, True), first(0, False))
    assert not torch.equal(first(0, True), first(1, True))


@pytest.mark.parametrize("dataset,match", [("nope", "no dataset")])
def test_parse_datasets_refuses_unported(tmp_path, dataset, match):
    with pytest.raises(NotImplementedError, match=match):
        parse_datasets(_cfg(tmp_path, False, dataset=dataset),
                       torch.device("cpu"))
