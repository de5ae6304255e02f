"""Vid-ODE's data path in the port against the JAX package: the four
window samplers (train and test) and ``split_batch``, the video
transforms, ``VideoCorpus`` on synthetic corpora (train with its
augmentation, test), ``parse_datasets`` on the seven corpora, and the
port's corpus writer against ``scripts/make_synthetic_corpus.py``'s
layout.

JAX draws from its PRNG and the port from a ``torch.Generator``; the
tests take JAX's draws (the same keys split the way JAX's functions
split them) and hand them to the port through a ``Noise`` that replays
them in order, checking each one's kind and shape. Tolerances: frames,
masks and batch dicts equal; transforms that resample (scale, rotation,
the corpus's resize) 1e-5 max abs (the grids lie within an fp32 ulp of
JAX's), the others equal or 1e-6.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import max_abs, np32, t32
from ode_rl_torch.core.config import Config
from ode_rl_torch.core.noise import Noise
from ode_rl_torch.data import samplers
from ode_rl_torch.data import video_transforms as vt
from ode_rl_torch.data.mmnist import parse_datasets
from ode_rl_torch.data.video_corpus import (DATASET_SPECS, RAW_SPECS,
                                            VideoCorpus,
                                            write_synthetic_corpus)

RESAMPLE_TOL = 1e-5


class Replay(Noise):
    """Hands out given draws in order: ("randint"|"uniform", array)."""

    def __init__(self, draws):
        super().__init__(None)
        self.draws = list(draws)

    def _next(self, kind, shape):
        got, a = self.draws.pop(0)
        a = np.asarray(a)
        assert got == kind and a.shape == tuple(shape), (got, a.shape,
                                                         kind, shape)
        return a

    def randint(self, low, high, shape, device):
        a = self._next("randint", shape)
        assert np.all((a >= low) & (a < high))
        return torch.from_numpy(a.astype(np.int64)).to(device)

    def uniform(self, shape, device, low=0.0, high=1.0):
        return t32(self._next("uniform", shape)).to(device)


def _uniform_rows(key, b, size):
    """JAX's vmapped per-sample uniform rows: split(key, b), each (size,)."""
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (size,)))(
        jax.random.split(key, b)))


def _sampler_draws(key, b, t, ss, ws, irregular, extrap, train):
    """The draws JAX's ``sample`` makes with ``key``, in the port's order."""
    randint = lambda k, hi: ("randint", np.asarray(
        jax.random.randint(k, (b,), 0, hi)))
    if not irregular:
        return [randint(key, t - ss + 1)] if train else []
    if extrap:
        k1, k2, k3 = jax.random.split(key, 3)
        rows = [("uniform", _uniform_rows(k2, b, ws)),
                ("uniform", _uniform_rows(k3, b, ws))]
    else:
        k1, k2 = jax.random.split(key)
        rows = [("uniform", _uniform_rows(k2, b, ws))]
    return ([randint(k1, t - ws)] if train and t > ws else []) + rows


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("irregular,extrap", [
    (False, False), (False, True), (True, False), (True, True)],
    ids=["regular_interp", "regular_extrap", "irregular_interp",
         "irregular_extrap"])
def test_samplers_and_split_match_jax(irregular, extrap, train):
    from ode_rl_tpu.data.samplers import sample as jax_sample
    from ode_rl_tpu.data.samplers import split_batch as jax_split

    b, t, ss, ws = 3, 24, 8, 12
    v = np.random.RandomState(0).rand(b, t, 2, 2, 1).astype(np.float32)
    key = jax.random.key(5)
    j_frames, j_mask = jax_sample(key, jnp.asarray(v), sample_size=ss,
                                  window_size=ws, irregular=irregular,
                                  extrap=extrap, train=train)
    replay = Replay(_sampler_draws(key, b, t, ss, ws, irregular, extrap,
                                   train))
    frames, mask = samplers.sample(replay, t32(v), sample_size=ss,
                                   window_size=ws, irregular=irregular,
                                   extrap=extrap, train=train)
    assert not replay.draws
    assert np.array_equal(np32(frames), np.asarray(j_frames))
    assert np.array_equal(np32(mask), np.asarray(j_mask))
    if irregular:
        assert np.all(np32(mask).sum(1) == ss)
    ours = samplers.split_batch(frames, mask, extrap)
    theirs = jax_split(j_frames, j_mask, extrap)
    assert set(ours) == set(theirs)
    for k in theirs:
        assert np.array_equal(np32(ours[k]), np.asarray(theirs[k])), k


def test_sample_takes_a_generator():
    """From a ``torch.Generator``: the same seed, the same windows."""
    v = torch.rand(2, 24, 2, 2, 1)
    run = lambda: samplers.sample(torch.Generator().manual_seed(3), v, 8,
                                  12, irregular=True, extrap=True)
    (f1, m1), (f2, m2) = run(), run()
    assert torch.equal(f1, f2) and torch.equal(m1, m2)
    assert m1.shape == (2, 12) and torch.all(m1.sum(1) == 8)


# ------------------------------ transforms --------------------------------

CLIP = np.random.RandomState(1).rand(3, 12, 10, 3).astype(np.float32)


@pytest.mark.parametrize("name", ["scale_up", "scale_down", "center_crop",
                                  "pad", "normalize"])
def test_deterministic_transforms_match_jax(name):
    from ode_rl_tpu.data import video_transforms as jvt

    clip, jclip = t32(CLIP), jnp.asarray(CLIP)
    cases = {
        "scale_up": (lambda m, c: m.scale(c, (20, 16)), RESAMPLE_TOL),
        "scale_down": (lambda m, c: m.scale(c, (5, 7)), RESAMPLE_TOL),
        "center_crop": (lambda m, c: m.center_crop(c, (7, 5)), 0.0),
        "pad": (lambda m, c: m.pad(c, 2, 0.25), 0.0),
        "normalize": (lambda m, c: m.normalize(c, [0.5, 0.4, 0.3],
                                               [0.2, 0.25, 0.5]), 1e-6),
    }
    fn, tol = cases[name]
    ours, theirs = fn(vt, clip), fn(jvt, jclip)
    assert ours.shape == theirs.shape
    assert max_abs(ours, theirs) <= tol


@pytest.mark.parametrize("name", ["random_crop", "flip", "rotation",
                                  "color_jitter", "cutout", "compose"])
def test_random_transforms_match_jax(name):
    """Each random transform with JAX's draws replayed."""
    from ode_rl_tpu.data import video_transforms as jvt

    clip, jclip = t32(CLIP), jnp.asarray(CLIP)
    key = jax.random.key(9)
    u = lambda k, lo=0.0, hi=1.0: ("uniform", np.asarray(
        jax.random.uniform(k, (), minval=lo, maxval=hi)))
    ri = lambda k, hi: ("randint", np.asarray(jax.random.randint(k, (), 0,
                                                                  hi)))
    if name == "random_crop":
        ky, kx = jax.random.split(key, 2)
        theirs = jvt.random_crop(key, jclip, (6, 4))
        ours = vt.random_crop(Replay([ri(ky, 7), ri(kx, 7)]), clip, (6, 4))
        tol = 0.0
    elif name == "flip":
        for k in (key, jax.random.key(2), jax.random.key(3)):
            theirs = jvt.random_horizontal_flip(k, jclip)
            ours = vt.random_horizontal_flip(Replay([u(k)]), clip)
            assert max_abs(ours, theirs) == 0.0, u(k)
        return
    elif name == "rotation":
        theirs = jvt.random_rotation(key, jclip, degrees=30.0)
        ours = vt.random_rotation(Replay([u(key, -30.0, 30.0)]), clip, 30.0)
        tol = RESAMPLE_TOL
    elif name == "color_jitter":
        kb, kc, ks = jax.random.split(key, 3)
        theirs = jvt.color_jitter(key, jclip)
        ours = vt.color_jitter(Replay([u(kb, -0.2, 0.2), u(kc, -0.2, 0.2),
                                       u(ks, -0.2, 0.2)]), clip)
        tol = 1e-6
    elif name == "cutout":
        ky, kx = jax.random.split(key, 2)
        theirs = jvt.cutout(key, jclip, size=4)
        ours = vt.cutout(Replay([ri(ky, 9), ri(kx, 7)]), clip, size=4)
        tol = 0.0
    else:
        k_crop, _, k_flip = jax.random.split(key, 3)
        ky, kx = jax.random.split(k_crop, 2)
        plan = lambda m: [(m.random_crop, {"size": (8, 8)}),
                          (m.scale, {"size": (16, 16)}),
                          (m.random_horizontal_flip, {"p": 0.5})]
        theirs = jvt.compose(key, jclip, plan(jvt))
        ours = vt.compose(Replay([ri(ky, 5), ri(kx, 3), u(k_flip)]), clip,
                          plan(vt))
        tol = RESAMPLE_TOL
    assert ours.shape == theirs.shape
    assert max_abs(ours, theirs) <= tol


# ------------------------------- the corpus -------------------------------

@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpora")
    for name in RAW_SPECS:
        write_synthetic_corpus(root / name, name, train_videos=3,
                               test_videos=2, seed=1, frames=14)
    # mmnist_video: 64x64 grayscale, no raw spec of its own.
    rng = np.random.RandomState(2)
    for split in ("train", "test"):
        (root / "mmnist_video" / split).mkdir(parents=True)
        for i in range(2):
            np.save(root / "mmnist_video" / split / f"video_{i}.npy",
                    (rng.rand(14, 64, 64) * 255).astype(np.uint8))
    return root


def _corpus_draws(key, b):
    """The flips, then the angles, JAX's ``_transform_batch`` draws with
    the loader's key (split once a batch, then once a clip)."""
    _, sub = jax.random.split(key)
    flips, angles = [], []
    for k in jax.random.split(sub, b):
        kf, kr = jax.random.split(k)
        flips.append(np.asarray(jax.random.uniform(kf)))
        angles.append(np.asarray(jax.random.uniform(
            kr, (), minval=-10.0, maxval=10.0)))
    return [("uniform", np.stack(flips)), ("uniform", np.stack(angles))]


@pytest.mark.parametrize("dataset", ["kth", "hurricane", "mgif"])
def test_video_corpus_matches_jax(corpora, dataset):
    """Two train batches (the same files and windows from the seeded
    host generator; kth and mgif augmented with JAX's draws replayed) and
    two test batches (the sequential sweep), 1e-5 max abs."""
    from ode_rl_tpu.data.video_corpus import VideoCorpus as JaxCorpus

    root = corpora / dataset
    size = DATASET_SPECS[dataset]["size"] or 64
    for train in (True, False):
        kw = dict(batch_size=2, clip_len=6, is_train=train, resolution=64,
                  seed=3)
        theirs = JaxCorpus(root, dataset, **kw)
        ours = VideoCorpus(root, dataset, **kw)
        augment = train and DATASET_SPECS[dataset]["augment"]
        for _ in range(2):
            if augment:
                ours._noise = Replay(_corpus_draws(theirs._key, 2))
            j = next(theirs)
            o = next(ours)
            assert o.shape == j.shape == (2, 6, size, size,
                                          DATASET_SPECS[dataset]["channels"])
            assert max_abs(o, j) <= RESAMPLE_TOL
            assert float(o.min()) >= -0.5 and float(o.max()) <= 0.5


@pytest.mark.parametrize("dataset", sorted(DATASET_SPECS))
def test_parse_datasets_reads_every_corpus(corpora, dataset):
    """The seven corpora through ``parse_datasets``: the batch counts and
    the ``frozen`` flag as JAX's, a batch of the window's length, and the
    test loader's ``test_seq`` in the test phase; ``data_dir`` may name
    the parent of the corpus."""
    from ode_rl_tpu.core.config import Config as JaxConfig
    from ode_rl_tpu.data.mmnist import parse_datasets as jax_parse

    for phase, data_dir in (("train", corpora / dataset), ("test", corpora)):
        entries = dict(dataset=dataset, data_dir=str(data_dir), batch_size=2,
                       phase=phase, window_size=6, train_seq=6, test_seq=8,
                       resolution=32, seed=0)
        ours = parse_datasets(Config(entries), torch.device("cpu"))
        theirs = jax_parse(JaxConfig(entries))
        for k in ("n_train_batches", "n_test_batches", "frozen"):
            assert ours[k] == theirs[k], k
        t_len = 8 if phase == "test" else 6
        assert next(ours["test_dataloader"]).shape[1] == t_len
        assert next(ours["train_dataloader"]).shape[1] == 6


def test_corpus_refuses_short_and_missing(corpora, tmp_path):
    with pytest.raises(ValueError, match="shorter"):
        VideoCorpus(corpora / "kth", "kth", 2, clip_len=15)
    with pytest.raises(FileNotFoundError, match="make_synthetic_corpus"):
        VideoCorpus(tmp_path, "kth", 2, clip_len=4)
    with pytest.raises(NotImplementedError, match="no dataset"):
        VideoCorpus(corpora / "kth", "ucf", 2, clip_len=4)


def test_reads_the_scripts_corpus(tmp_path):
    """A corpus that ``scripts/make_synthetic_corpus.py`` writes reads
    through the port's loader, at the shapes the port's writer gives."""
    subprocess.run([sys.executable, "scripts/make_synthetic_corpus.py",
                    "--dataset", "hurricane", "--out", str(tmp_path / "h"),
                    "--train_videos", "2", "--test_videos", "1"], check=True)
    write_synthetic_corpus(tmp_path / "p", "hurricane", 2, 1)
    for root in (tmp_path / "h", tmp_path / "p"):
        files = sorted((root / "train").glob("*.npy"))
        assert len(files) == 2
        v = np.load(files[0])
        assert v.dtype == np.uint8 and v.shape[1:] == (65, 63, 6)
        batch = next(VideoCorpus(root, "hurricane", 2, clip_len=10))
        assert batch.shape == (2, 10, 64, 64, 6)
