"""FlowNet weights and FlowNet DFP labels in the PyTorch port against the
JAX package: the msgpack codec against flax's (each reads what the other
writes, bf16 and fp32 leaves and a FlowNetC tree, byte for byte),
``torch_to_flax`` as the inverse of ``flax_to_torch`` on the FlowNetC,
FlowNetS and FlowNet2 state dicts (FlowNet2 on the ``meta`` device), a
FlowNetC saved by either package loaded by the other, ``graft_params``'s
counts at the FlowNet2 warm start (``jax.eval_shape`` trees against the
port's modules on ``meta``), ``flow_grid_labels``, ``make_flownet_label_fn``,
``make_batch_dict``'s label function, the loop's missing-weights error
and ``allow_random_flownet``, and ``train_mmnist_recon_s3vae`` with FlowNet
labels through ``ode_rl_torch.main`` on the CPU.

Tolerances: the codec and the weights exact; forwards 1e-5 max abs; the
upsampled flow 1e-4 max abs; labels exact on every cell more than 1e-4
from its transition's k-th value (a cell within fp32 noise of the
threshold may flip), and exact everywhere where both sides label the
same flow.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_flax, max_abs, np32, t32
from ode_rl_torch.convert import flax_to_torch, torch_to_flax
from ode_rl_torch.core import msgpack
from ode_rl_torch.data.flow_labels import (flow_grid_labels,
                                           make_flownet_label_fn)
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.flow import flownets
from ode_rl_torch.flow.train import (graft_params, load_flax_params,
                                     load_flownet_params,
                                     save_flownet_params)
from ode_rl_torch.ops.resize import resize_bilinear

LABEL_MARGIN = 1e-4


def _tree_equal(a, b) -> None:
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            x = np.asarray(a[k].float() if isinstance(a[k], torch.Tensor)
                           else a[k])
            y = np.asarray(b[k].float() if isinstance(b[k], torch.Tensor)
                           else jnp.asarray(b[k]).astype(jnp.float32)
                           if getattr(b[k], "dtype", None) == jnp.bfloat16
                           else b[k])
            assert x.shape == y.shape, k
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def flax_flownetc():
    """JAX's FlowNetC and its variables (init key 3)."""
    from ode_rl_tpu.flow.flownets import FlowNetC

    net = FlowNetC()
    dummy = jnp.zeros((1, 64, 64, 3))
    return net, net.init(jax.random.key(3), dummy, dummy)


# --------------------------------- codec ----------------------------------

def _mixed_tree():
    rng = np.random.RandomState(0)
    return {"params": {
        "dense": {"kernel": rng.randn(3, 5).astype(np.float32),
                  "bias": np.zeros(5, np.float32)},
        "half": {"kernel": np.asarray(jnp.asarray(rng.randn(4, 2),
                                                  jnp.bfloat16))},
        "count": np.arange(300, dtype=np.int64).reshape(3, 100),
        "empty": np.zeros((0, 3), np.float32)},
        "step": 70000, "neg": -200, "rate": 0.5, "name": "flownetc",
        "scalar": np.float32(2.5)}


def test_msgpack_writes_flax_bytes_and_reads_them():
    """The port's bytes are flax's ``to_bytes`` of the same tree, and each
    side restores the other's."""
    from flax import serialization

    tree = _mixed_tree()
    theirs = serialization.to_bytes(tree)
    half = tree["params"]["half"]["kernel"]
    ours_tree = {**tree, "params": {**tree["params"], "half": {
        "kernel": torch.from_numpy(np.array(
            jnp.asarray(half).astype(jnp.float32))).bfloat16()}}}
    assert msgpack.dumps(ours_tree) == theirs
    back = msgpack.loads(theirs)
    assert back["params"]["half"]["kernel"].dtype == torch.bfloat16
    assert isinstance(back["scalar"], np.float32) and back["scalar"] == 2.5
    assert (back["step"], back["neg"], back["rate"], back["name"]) == (
        70000, -200, 0.5, "flownetc")
    _tree_equal(back["params"], tree["params"])
    _tree_equal(serialization.msgpack_restore(msgpack.dumps(ours_tree))[
        "params"], tree["params"])


def test_msgpack_round_trips_a_flownetc_tree(flax_flownetc):
    from flax import serialization

    _, variables = flax_flownetc
    data = serialization.to_bytes(variables)
    ours = msgpack.loads(data)
    _tree_equal(ours, jax.tree_util.tree_map(np.asarray, variables))
    assert msgpack.dumps(ours) == data


def test_msgpack_refuses_other_ext_types_and_trailing_bytes():
    from flax import serialization

    complex_bytes = serialization.msgpack_serialize({"c": 1 + 2j})
    with pytest.raises(ValueError, match="ext type 2"):
        msgpack.loads(complex_bytes)
    with pytest.raises(ValueError, match="after the tree"):
        msgpack.loads(msgpack.dumps({"a": 1}) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        msgpack.loads(msgpack.dumps({"a": "text"})[:-2])


# ------------------------------- layouts ----------------------------------

@pytest.mark.parametrize("name", ["FlowNetC", "FlowNetS", "FlowNet2"])
def test_torch_to_flax_inverts_flax_to_torch(name):
    """flax_to_torch(torch_to_flax(sd)) == sd, and the flax tree has the
    shapes of ``jax.eval_shape`` of the flax module's init (FlowNet2 on
    the meta device: names, shapes and dtypes only)."""
    import ode_rl_tpu.flow.flownets as jax_flownets

    meta = name == "FlowNet2"
    with torch.device("meta" if meta else "cpu"):
        port = getattr(flownets, name)(generator=torch.Generator())
    state = port.state_dict()
    tree = torch_to_flax(state, port)
    for by_type in (True, False):
        back = flax_to_torch(tree, module=port if by_type else None)
        assert set(back) == set(state)
        for k, v in state.items():
            assert back[k].shape == v.shape and back[k].dtype == v.dtype, k
            if not meta:
                assert torch.equal(back[k], v), k
    shapes = ([(1, 64, 64, 6)] if name == "FlowNetS"
              else [(1, 64, 64, 3)] * 2)
    abstract = jax.eval_shape(
        getattr(jax_flownets, name)().init, jax.random.key(0),
        *[jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes])["params"]
    ref = {"/".join(str(k.key) for k in p): tuple(v.shape) for p, v in
           jax.tree_util.tree_flatten_with_path(abstract)[0]}
    ours = {"/".join(str(k.key) for k in p): tuple(v.shape) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert ours == ref


# ------------------------------- weights ----------------------------------

def _pair(seed=0, b=2):
    rng = np.random.RandomState(seed)
    return [rng.uniform(0, 1, (b, 64, 64, 3)).astype(np.float32)
            for _ in range(2)]


def test_a_flownetc_saved_by_jax_loads_into_the_port(tmp_path,
                                                     flax_flownetc):
    from ode_rl_tpu.flow.train import save_flownet_params as jax_save

    net, variables = flax_flownetc
    path = tmp_path / "flownetc.msgpack"
    jax_save({"params": variables}, path)
    port = flownets.FlowNetC(generator=torch.Generator().manual_seed(9))
    load_flax_params(port, load_flownet_params(path)["params"])
    i1, i2 = _pair(1)
    ref = net.apply(variables, jnp.asarray(i1), jnp.asarray(i2))
    with torch.no_grad():
        ours = port(t32(i1), t32(i2))
    assert max(max_abs(a, b) for a, b in zip(ours, ref)) <= 1e-5


def test_a_flownetc_saved_by_the_port_loads_into_jax(tmp_path,
                                                     flax_flownetc):
    """The port's file restores into JAX's FlowNetC (from_bytes against
    its init, as JAX's loop loads ``flownet_params_path``), gives the
    port's forward, and is byte for byte the file JAX writes for those
    weights."""
    from flax import serialization

    from ode_rl_tpu.flow.train import load_flownet_params as jax_load

    net, variables = flax_flownetc
    port = flownets.FlowNetC(generator=torch.Generator().manual_seed(4))
    path = tmp_path / "flow" / "flownetc.msgpack"
    save_flownet_params(port, path)
    restored = serialization.from_bytes(variables, path.read_bytes())
    assert set(jax_load(path)) == {"params"}
    assert serialization.to_bytes(restored) == path.read_bytes()
    i1, i2 = _pair(2)
    ref = net.apply(restored, jnp.asarray(i1), jnp.asarray(i2))
    with torch.no_grad():
        ours = port(t32(i1), t32(i2))
    assert max(max_abs(a, b) for a, b in zip(ours, ref)) <= 1e-5
    _tree_equal(torch_to_flax(port.state_dict(), port),
                jax.tree_util.tree_map(np.asarray, restored["params"]))


def _zero_tree(flax_module, shapes):
    """A numpy tree of broadcast zeros (no memory) with the structure and
    shapes of ``flax_module.init``, and its ``jax.eval_shape`` tree."""
    abstract = jax.eval_shape(
        flax_module.init, jax.random.key(0),
        *[jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes])["params"]
    zeros = jax.tree_util.tree_map(
        lambda a: np.broadcast_to(np.zeros((), a.dtype), a.shape), abstract)
    return zeros, abstract


def test_graft_counts_at_the_flownet2_warm_start_match_jax():
    """FlowNetC into css.flownetcs.flownetc, FlowNetS into
    css.flownetcs.flownets1 and css.flownets2 (its 6-channel conv1 kernel
    skipped against their 12): JAX's (grafted, skipped) on eval_shape
    trees, the port's on modules on the meta device."""
    import ode_rl_tpu.flow.flownets as jax_flownets
    from ode_rl_tpu.flow.train import graft_params as jax_graft

    donor_c, _ = _zero_tree(jax_flownets.FlowNetC(), [(1, 64, 64, 3)] * 2)
    donor_s, _ = _zero_tree(jax_flownets.FlowNetS(), [(1, 64, 64, 6)])
    _, stack = _zero_tree(jax_flownets.FlowNet2(), [(1, 64, 64, 3)] * 2)
    with torch.device("meta"):
        port = flownets.FlowNet2(generator=torch.Generator())
    for dst, sub, donor in (
            (stack["css"]["flownetcs"]["flownetc"],
             port.css.flownetcs.flownetc, donor_c),
            (stack["css"]["flownetcs"]["flownets1"],
             port.css.flownetcs.flownets1, donor_s),
            (stack["css"]["flownets2"], port.css.flownets2, donor_s)):
        _, *ref = jax_graft(dst, donor)
        state, *ours = graft_params(sub, donor)
        assert ours == ref
        assert set(state) == set(sub.state_dict())
    assert ref == [41, 1]


def test_graft_copies_the_donor_and_keeps_the_mismatched_leaf():
    donor = flownets.FlowNetS(generator=torch.Generator().manual_seed(1))
    dst = flownets.FlowNetS(12, generator=torch.Generator().manual_seed(2))
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    state, grafted, skipped = graft_params(
        dst, jax.tree_util.tree_map(
            lambda t: t.numpy(), torch_to_flax(donor.state_dict(), donor)))
    assert (grafted, skipped) == (41, 1)
    for k, v in state.items():
        want = before[k] if k == "conv1.conv.weight" else donor.state_dict()[k]
        assert torch.equal(v, want), k


# -------------------------------- labels ----------------------------------

def _clear(flow: np.ndarray, grid=3, topk=3) -> np.ndarray:
    """Cells whose mean flow magnitude lies more than LABEL_MARGIN from
    their transition's k-th value."""
    b, t, h, w, _ = flow.shape
    g = h // grid
    mag = np.sqrt((flow.astype(np.float64) ** 2).sum(-1))
    m = mag[:, :, :grid * g, :grid * g].reshape(b, t, grid, g, grid, g
                                                ).mean((3, 5))
    m = m.reshape(b, t, grid * grid)
    kth = np.sort(m, -1)[..., -topk, None]
    return np.abs(m - kth) > LABEL_MARGIN


def test_flow_grid_labels_match_jax():
    from ode_rl_tpu.data.flow_labels import flow_grid_labels as jax_labels

    flow = (np.random.RandomState(5).randn(2, 3, 64, 64, 2) * 2
            ).astype(np.float32)
    flow[0, 0] = 0.0  # every cell ties at 0: all nine labelled
    ref = np32(jax_labels(jnp.asarray(flow)))
    ours = flow_grid_labels(t32(flow))
    assert ours.shape == (2, 3, 9) and ours.dtype == torch.float32
    np.testing.assert_array_equal(np32(ours), ref)
    assert ref[0, 0].sum() == 9 and np.all(ref.sum(-1) >= 3)


def _mmnist(seed, b, t):
    from ode_rl_tpu.data.mmnist import generate_moving_mnist
    from ode_rl_tpu.data.sprites import get_sprite_bank

    return np.asarray(generate_moving_mnist(
        jax.random.key(seed), jnp.asarray(get_sprite_bank(None)), batch=b,
        n_frames=t, num_digits=2))


def _jax_label_flow(net, variables, video01):
    """JAX's label function's flow: FlowNetC's finest flow between
    consecutive frames, resized x4."""
    b, t, h, w, c = video01.shape
    img = jnp.repeat(jnp.asarray(video01), 3, axis=-1)[..., :3]
    i1 = img[:, :-1].reshape(b * (t - 1), h, w, 3)
    i2 = img[:, 1:].reshape(b * (t - 1), h, w, 3)
    flows = net.apply(variables, i1, i2)
    full = jax.image.resize(flows[0], (b * (t - 1), h, w, 2),
                            "bilinear") * 4.0
    return np.asarray(full).reshape(b, t - 1, h, w, 2)


def test_make_flownet_label_fn_matches_jax(flax_flownetc):
    """Moving MNIST (B=2, T=3): the upsampled flow to 1e-4, the labels
    exactly on the clear cells; the port's labels are those of its flow."""
    from ode_rl_tpu.data.flow_labels import make_flownet_label_fn as jax_fn

    net, variables = flax_flownetc
    video = _mmnist(0, 2, 3) + 0.5
    ref = np32(jax_fn(net, variables)(jnp.asarray(video)))
    ref_flow = _jax_label_flow(net, variables, video)
    port = flownets.FlowNetC(generator=torch.Generator())
    load_flax(port, variables["params"])
    ours = make_flownet_label_fn(port)(t32(video))
    with torch.no_grad():
        i1 = t32(video[:, :-1]).reshape(4, 64, 64, 1).expand(-1, -1, -1, 3)
        i2 = t32(video[:, 1:]).reshape(4, 64, 64, 1).expand(-1, -1, -1, 3)
        flow = (resize_bilinear(port(i1, i2)[0], 64, 64) * 4.0).reshape(
            2, 2, 64, 64, 2)
    assert max_abs(flow, ref_flow) <= 1e-4
    assert torch.equal(ours, flow_grid_labels(flow))
    clear = _clear(ref_flow)
    assert clear.sum() >= clear.size // 2
    np.testing.assert_array_equal(np32(ours)[clear], ref[clear])
    assert not any(p.grad is not None for p in port.parameters())


def test_make_batch_dict_takes_the_label_function_as_jax():
    """The function sees the video in [0, 1]; in- and out-labels are its
    first n_in - 1 transitions."""
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch

    video = _mmnist(1, 2, 6)
    seen = []

    def fn(v):
        seen.append(v)
        return v[:, 1:, :3, :3, 0].reshape(v.shape[0], -1, 9) * 2.0

    ours = make_batch_dict(t32(video), 4, with_flow_labels=True,
                           flow_label_fn=fn)
    ref = jax_batch(jnp.asarray(video), 4, with_flow_labels=True,
                    flow_label_fn=fn)
    assert max_abs(seen[0], video + 0.5) == 0.0
    for key in ("in_flow_labels", "out_flow_labels"):
        assert ours[key].shape == (2, 3, 9)
        np.testing.assert_array_equal(np32(ours[key]), np32(ref[key]))


# --------------------------------- loop -----------------------------------

NARROW = ["--encoder_out_dims", "16", "--d_zf", "8", "--d_zt", "8",
          "--batch_size", "2", "--train_in_seq", "3", "--train_out_seq", "3",
          "--loss_log_freq", "1"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A frozen corpus of 64x64 Moving MNIST (FlowNetC needs multiples of
    64): 4 train videos of 8 frames, 2 test videos of 20."""
    root = tmp_path_factory.mktemp("frozen")
    for split, n, frames, seed in (("train", 4, 8, 2), ("test", 2, 20, 3)):
        (root / split).mkdir()
        v = _mmnist(seed, n, frames)[..., 0]
        np.save(root / split / "shard_0000.npy",
                np.round((v + 0.5) * 255).astype(np.uint8))
    (root / "meta.json").write_text(json.dumps({"frames": 8}))
    return root


def _argv(corpus, logs, *extra):
    return ["--configs", "defaults", "train_mmnist_recon_s3vae", "--device",
            "cpu", "--data_dir", str(corpus), "--logdir", str(logs),
            "--steps_per_epoch", "2", "--epochs", "1", *NARROW,
            "--flow_label_source", "flownet", *extra]


def test_missing_weights_raise_and_allow_random_warns(tmp_path, corpus,
                                                      capsys):
    from ode_rl_torch.main import main

    missing = str(tmp_path / "none.msgpack")
    with pytest.raises(FileNotFoundError,
                       match="python -m ode_rl_torch.train_flownetc"):
        main(_argv(corpus, tmp_path / "a", "--flownet_params_path", missing))
    out = main(_argv(corpus, tmp_path / "b", "--flownet_params_path",
                     missing, "--allow_random_flownet", "True",
                     "--steps_per_epoch", "1"))
    assert out["final_step"] == 1 and np.isfinite(out["dfp_loss"])
    assert "allow_random_flownet=True" in capsys.readouterr().out


def test_main_trains_s3vae_on_jax_flownet_labels(tmp_path, corpus,
                                                 flax_flownetc, monkeypatch):
    """``defaults train_mmnist_recon_s3vae`` (narrowed) with JAX-saved
    FlowNetC weights: two steps on the frozen corpus, each batch's labels
    JAX's labels of the same video (clear cells exactly), no K5-K7 launch
    on the CPU; then the test block from its checkpoint."""
    from ode_rl_tpu.data.flow_labels import make_flownet_label_fn as jax_fn
    from ode_rl_tpu.flow.train import save_flownet_params as jax_save
    from ode_rl_torch.main import main
    from ode_rl_torch.ops import common
    from ode_rl_torch.train import loop

    net, variables = flax_flownetc
    params = tmp_path / "flownetc.msgpack"
    jax_save({"params": variables}, params)
    batches = []
    real = loop.make_train_step

    def recording(*args, **kwargs):
        step = real(*args, **kwargs)

        def run(state, batch, generator=None):
            batches.append(batch)
            return step(state, batch, generator)

        return run

    monkeypatch.setattr(loop, "make_train_step", recording)
    common.reset_launches()
    out = main(_argv(corpus, tmp_path / "logs", "--flownet_params_path",
                     str(params)))
    assert out["final_step"] == 2 and np.isfinite(out["loss"])
    assert all(n == 0 for n in common.launches.values())
    assert len(batches) == 2
    label_fn = jax_fn(net, variables)
    for batch in batches:
        video = np32(torch.cat([batch["observed_data"],
                                batch["data_to_predict"]], 1)) + 0.5
        ref = np32(label_fn(jnp.asarray(video)))[:, :2]
        clear = _clear(_jax_label_flow(net, variables, video))[:, :2]
        ours = np32(batch["in_flow_labels"])
        assert ours.shape == (2, 2, 9)
        np.testing.assert_array_equal(ours[clear], ref[clear])
        assert np.array_equal(ours, np32(batch["out_flow_labels"]))
    out = main(["--configs", "defaults", "test_mmnist_recon_s3vae",
                "--device", "cpu", "--data_dir", str(corpus), "--logdir",
                str(tmp_path / "logs"), "--eval_batches", "1",
                "--batch_size", "2", "--test_in_seq", "3",
                "--test_out_seq", "3"])
    assert np.isfinite(out["final_mse"])
