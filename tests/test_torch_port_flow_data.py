"""The flow data path of the PyTorch port against the JAX package: ``.flo``
files written by either side and read by the other, PPM and PNG images
``imageio`` wrote read by the port's numpy decoders, FlyingChairs-layout
corpora written by either side and read by both (batch for batch, bit
for bit), the invariant of each synthetic style the port writes,
``validate_epe`` on the same weights (FlowNetC and FlowNetS), the
'smooth' and high-resolution batches on the same noise, and
``resize_bicubic``.

Tolerances: file contents and corpus batches exact; resize and the
synthetic batches 1e-5 max abs; EPE 1e-5 relative.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_flax, max_abs, np32, t32
from ode_rl_torch.data.mmnist import generate_moving_mnist as port_mmnist
from ode_rl_torch.flow import data as port_data
from ode_rl_torch.flow import flownets
from ode_rl_torch.convert import flax_to_torch
from ode_rl_torch.flow.train import (smooth_flow_from, synthetic_flow_batch,
                                     train_flownet)
from ode_rl_torch.ops.resize import resize_bicubic
from ode_rl_torch.train_flownetc_highres import highres_batch_from

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def bank():
    from ode_rl_tpu.data.sprites import get_sprite_bank

    return get_sprite_bank(None)


# --------------------------------- .flo -----------------------------------

def test_flo_round_trip_both_ways(tmp_path):
    from ode_rl_tpu.flow import data as jax_data

    flow = np.random.RandomState(0).randn(48, 64, 2).astype(np.float32)
    port_data.write_flo(tmp_path / "port.flo", flow)
    jax_data.write_flo(tmp_path / "jax.flo", flow)
    assert ((tmp_path / "port.flo").read_bytes()
            == (tmp_path / "jax.flo").read_bytes())
    np.testing.assert_array_equal(jax_data.read_flo(tmp_path / "port.flo"),
                                  flow)
    np.testing.assert_array_equal(port_data.read_flo(tmp_path / "jax.flo"),
                                  flow)
    (tmp_path / "bad.flo").write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError, match="magic"):
        port_data.read_flo(tmp_path / "bad.flo")


# -------------------------------- images ----------------------------------

@pytest.mark.parametrize("name,channels", [
    ("rgb.ppm", 3), ("rgb.png", 3), ("gray.png", 1), ("rgba.png", 4),
    ("gray.pgm.ppm", 1)])
def test_images_imageio_wrote_read_as_jax_reads_them(tmp_path, name,
                                                     channels):
    """Random and smooth content, so that PIL's adaptive PNG filters take
    several of the five filter types; gray decodes repeated to 3
    channels and alpha dropped, as JAX's reader gives them."""
    import imageio.v2 as imageio

    from ode_rl_tpu.flow import data as jax_data

    rng = np.random.RandomState(len(name))
    ramp = np.add.outer(np.arange(37), np.arange(53)) % 256
    img = np.stack([ramp, rng.randint(0, 256, (37, 53)), ramp[::-1],
                    np.full((37, 53), 200)], -1)[..., :channels]
    img = img.astype(np.uint8)
    path = tmp_path / name
    if name.endswith(".pgm.ppm"):
        # A binary PGM (P5) with a header comment, under .ppm.
        path.write_bytes(b"P5\n# a comment\n53 37\n255\n" + img.tobytes())
    else:
        imageio.imwrite(path, img[..., 0] if channels == 1 else img)
    ours = port_data._read_image(path)
    ref = jax_data._read_image(path)
    assert ours.shape == (37, 53, 3) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_ppm_written_by_the_port_reads_in_imageio(tmp_path):
    import imageio.v2 as imageio

    img = np.random.RandomState(1).randint(0, 256, (5, 7, 3), np.uint8)
    port_data.write_ppm(tmp_path / "a.ppm", img)
    np.testing.assert_array_equal(np.asarray(imageio.imread(
        tmp_path / "a.ppm")), img)


def test_other_image_formats_raise_and_name_the_read_ones(tmp_path):
    (tmp_path / "a.jpg").write_bytes(b"\xff\xd8")
    with pytest.raises(ValueError, match="PPM.*PNG"):
        port_data._read_image(tmp_path / "a.jpg")


# -------------------------------- corpora ---------------------------------

def _batches(corpus, n):
    return [next(corpus) for _ in range(n)]


def _assert_same_batches(root, **kw):
    from ode_rl_tpu.flow import data as jax_data

    for is_train in (True, False):
        ours = port_data.FlyingChairsCorpus(root, is_train=is_train, **kw)
        ref = jax_data.FlyingChairsCorpus(root, is_train=is_train, **kw)
        assert len(ours) == len(ref)
        assert ours.pairs == ref.pairs and ours.flows == ref.flows
        for a, b in zip(_batches(ours, 3), _batches(ref, 3)):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def jax_chairs(tmp_path_factory):
    from ode_rl_tpu.flow.data import write_synthetic_chairs

    return write_synthetic_chairs(tmp_path_factory.mktemp("jax_chairs"),
                                  n_pairs=10, seed=3)


def test_a_jax_corpus_gives_the_port_jax_batches(jax_chairs):
    """One directory and seed: the same pairing, split, draws and cursor,
    so every batch is JAX's bit for bit."""
    _assert_same_batches(jax_chairs, batch_size=3, seed=5)
    _assert_same_batches(jax_chairs, batch_size=2, seed=0, train_split=0.5)


@pytest.mark.parametrize("style", ["digits", "smooth"])
def test_a_port_corpus_reads_in_jax(tmp_path, style):
    port_data.write_synthetic_chairs(tmp_path, n_pairs=9, seed=2,
                                     style=style)
    assert len(list(tmp_path.glob("*.ppm"))) == 18
    _assert_same_batches(tmp_path, batch_size=4, seed=1)


def test_smooth_pairs_are_warps_of_their_flow(tmp_path):
    """'smooth' pairs: img2 is img1 warped backwards by the stored flow,
    to the ppm quantisation (2e-2 mean)."""
    from ode_rl_tpu.ops.warp import resample2d

    port_data.write_synthetic_chairs(tmp_path, n_pairs=4, seed=6,
                                     style="smooth")
    img1, img2, flow = next(port_data.FlyingChairsCorpus(
        tmp_path, batch_size=4, is_train=False, train_split=0.0))
    warped = np.asarray(resample2d(jnp.asarray(img1), jnp.asarray(flow)))
    assert np.abs(warped - img2).mean() < 2e-2


def test_digits_pairs_round_trip_their_batch(tmp_path, bank):
    """'digits' pairs (forward flow, img2(p + flow(p)) = img1(p), so not a
    resample2d warp): the corpus holds the in-memory batch, images within
    the uint8 truncation (1/255) and the flow bit for bit."""
    port_data.write_synthetic_chairs(tmp_path, n_pairs=8, seed=4)
    img1, img2, flow = synthetic_flow_batch(
        torch.Generator().manual_seed(4), torch.from_numpy(bank).float(),
        batch=8)
    got = next(port_data.FlyingChairsCorpus(tmp_path, batch_size=8,
                                            is_train=False,
                                            train_split=0.0))
    for disk, mem in zip(got[:2], (img1, img2)):
        diff = np32(mem) - disk
        assert diff.min() >= 0.0 and diff.max() < 1 / 255
    np.testing.assert_array_equal(got[2], np32(flow))


def test_write_synthetic_chairs_refuses_other_sizes(tmp_path):
    with pytest.raises(ValueError, match="64x64"):
        port_data.write_synthetic_chairs(tmp_path, n_pairs=1, size=128)


# --------------------------------- EPE ------------------------------------

@pytest.mark.parametrize("net", ["FlowNetC", "FlowNetS"])
def test_validate_epe_matches_jax(jax_chairs, net):
    """The same weights (JAX's init, converted) over the same held-out
    batches: the mean EPE of the finest flow resized x4."""
    import ode_rl_tpu.flow.flownets as jax_flownets
    from ode_rl_tpu.flow import data as jax_data

    pair_input = net == "FlowNetS"
    shapes = ([(1, 64, 64, 6)] if pair_input
              else [(1, 64, 64, 3), (1, 64, 64, 3)])
    flax_net = getattr(jax_flownets, net)()
    variables = flax_net.init(jax.random.key(2),
                              *[jnp.zeros(s) for s in shapes])
    ref = jax_data.validate_epe(
        flax_net, variables, jax_data.FlyingChairsCorpus(
            jax_chairs, batch_size=2, is_train=False, train_split=0.6),
        pair_input=pair_input)
    port = getattr(flownets, net)(generator=torch.Generator())
    load_flax(port, variables["params"])
    ours = port_data.validate_epe(
        port, port_data.FlyingChairsCorpus(
            jax_chairs, batch_size=2, is_train=False, train_split=0.6),
        pair_input=pair_input)
    assert abs(ours / ref - 1.0) <= 1e-5


# -------------------------- batches and resize ----------------------------

@pytest.mark.parametrize("shape,size", [((2, 4, 4, 2), (64, 64)),
                                        ((2, 5, 7, 2), (320, 448))])
def test_resize_bicubic_matches_jax(shape, size):
    x = np.random.RandomState(3).randn(*shape).astype(np.float32) * 3.0
    ref = jax.image.resize(jnp.asarray(x), (shape[0], *size, 2), "bicubic")
    assert max_abs(resize_bicubic(t32(x), *size), ref) <= 1e-5


def test_smooth_batch_matches_jax_on_the_same_noise(bank):
    """JAX's 'smooth' branch (synthetic_flow_batch) computed on the same
    frame and coarse noise; and the port's generator's batch is
    smooth_flow_from of its own draws."""
    from ode_rl_tpu.data.mmnist import generate_moving_mnist
    from ode_rl_tpu.ops.warp import resample2d

    k1, k2 = jax.random.split(jax.random.key(9))
    video = generate_moving_mnist(k1, jnp.asarray(bank), batch=3,
                                  n_frames=1, num_digits=3) + 0.5
    img1 = jnp.repeat(video[:, 0], 3, axis=-1)
    coarse = jax.random.normal(k2, (3, 4, 4, 2)) * 3.0
    flow = jax.image.resize(coarse, (3, 64, 64, 2), "bicubic")
    ref = (img1, resample2d(img1, flow), flow)
    ours = smooth_flow_from(t32(img1), t32(coarse))
    for a, b in zip(ours, ref):
        assert max_abs(a, b) <= 1e-5
    t_bank = torch.from_numpy(bank).float()
    gen = torch.Generator().manual_seed(0)
    batch = synthetic_flow_batch(gen, t_bank, batch=2, style="smooth")
    assert batch[0].shape == batch[1].shape == (2, 64, 64, 3)
    assert float(batch[0].min()) >= 0.0 and float(batch[0].max()) <= 1.0
    draws = torch.Generator().manual_seed(0)
    frame = port_mmnist(draws, t_bank, batch=2, n_frames=1,
                        num_digits=3)[:, 0] + 0.5
    noise = torch.randn((2, 4, 4, 2), generator=draws) * 3.0
    for a, b in zip(batch, smooth_flow_from(frame.expand(-1, -1, -1, 3),
                                            noise)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="style"):
        synthetic_flow_batch(gen, torch.from_numpy(bank).float(),
                             style="chairs")


def test_highres_batch_matches_jax_on_the_same_noise():
    """The script's batch_fn on one frame and (B, 5, 7, 2) noise times 8
    (at 80x112, where JAX's one-hot warp fits in CPU memory; the bicubic
    resize is held at 320x448 above)."""
    from ode_rl_tpu.ops.warp import resample2d

    text = ast.unparse(ast.parse(
        (REPO / "scripts/train_flownetc_highres.py").read_text()))
    for piece in ("(b, 5, 7, 2)) * 8.0", "'bilinear'", "'bicubic'",
                  "resample2d(img1, flow)"):
        assert piece in text, piece
    rng = np.random.RandomState(4)
    frame = rng.uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)
    coarse = (rng.randn(2, 5, 7, 2) * 8.0).astype(np.float32)
    h, w = 80, 112
    img1 = jax.image.resize(jnp.repeat(jnp.asarray(frame), 3, axis=-1),
                            (2, h, w, 3), "bilinear")
    flow = jax.image.resize(jnp.asarray(coarse), (2, h, w, 2), "bicubic")
    ref = (img1, resample2d(img1, flow), flow)
    ours = highres_batch_from(t32(frame), t32(coarse), h, w)
    for a, b in zip(ours, ref):
        assert max_abs(a, b) <= 1e-5


def test_train_flownet_on_a_corpus_matches_jax(jax_chairs):
    """``train_flownet`` on the corpus from the same weights: one step's
    loss and EPE on the same drawn batch (the init draw dropped on both
    sides), and with no step the held-out EPE of those weights."""
    from ode_rl_tpu.flow import FlowNetS
    from ode_rl_tpu.flow.train import train_flownet as jax_train

    variables = FlowNetS().init(jax.random.key(4),
                                jnp.zeros((1, 64, 64, 6)))
    for steps in (0, 1):
        ref = jax_train(FlowNetS(), steps=steps, batch=2, seed=3,
                        data_root=jax_chairs, validate=True,
                        init_params=variables)
        port = flownets.FlowNetS(generator=torch.Generator())
        ours = train_flownet(
            port, steps=steps, batch=2, seed=3, data_root=jax_chairs,
            validate=True, init_params=flax_to_torch(jax.tree_util.tree_map(
                np.asarray, variables["params"]), module=port))
        keys = ("val_epe",) if steps == 0 else ("loss", "epe")
        for key in keys:
            assert abs(ours[key] / ref[key] - 1.0) <= 1e-5, key
