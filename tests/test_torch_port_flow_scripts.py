"""The port's FlowNet commands end to end on the CPU against the JAX
package's scripts: ``python -m ode_rl_torch.train_flownetc`` (FlowNetC and
FlowNetS, a few steps: the report's keys, the weights file JAX loads and
whose held-out EPE in JAX is the report's), ``train_flownetc_highres`` (a
few steps at 64x64: the report and the script's EPE check), and
``get_labels_from_pred_flow`` on both corpus layouts against the script's
labels; each command's flags and defaults against its script's.

Tolerances: EPE 1e-5 relative; labels exact on every cell more than 1e-4
from its transition's k-th value.
"""

import ast
import importlib.util
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_flax, np32, t32
from test_torch_port_flow_labels import _clear, _mmnist
from ode_rl_torch import (get_labels_from_pred_flow, train_flownetc,
                          train_flownetc_highres)
from ode_rl_torch.flow import flownets
from ode_rl_torch.flow.data import write_synthetic_chairs
from ode_rl_torch.ops.resize import resize_bilinear

REPO = pathlib.Path(__file__).resolve().parents[1]


def _script_flags(script: str) -> dict:
    """{flag: default} of the script's add_argument calls (store_true
    flags default to False)."""
    tree = ast.parse((REPO / "scripts" / script).read_text())
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            name = node.args[0].value.lstrip("-")
            if "default" in kw:
                flags[name] = ast.literal_eval(kw["default"])
            elif (isinstance(kw.get("action"), ast.Constant)
                  and kw["action"].value == "store_true"):
                flags[name] = False
            else:
                flags[name] = None
    return flags


def _script_report_keys(script: str) -> set:
    tree = ast.parse((REPO / "scripts" / script).read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "report"):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"{script}: no report dict")


@pytest.mark.parametrize("script,module,own,moved", [
    ("train_flownetc.py", train_flownetc, {"flow_dir", "device"},
     {"report"}),
    ("train_flownetc_highres.py", train_flownetc_highres, {"device"},
     {"report"}),
    ("get_labels_from_pred_flow.py", get_labels_from_pred_flow, {"device"},
     set())])
def test_flags_and_defaults_are_the_scripts(script, module, own, moved):
    """The same flags with the same defaults; the port adds ``own`` and
    writes its report under results/torch."""
    ref = _script_flags(script)
    required = [a for a in ("data",) if a in ref]
    ours = vars(module.parse_args([f"--{a}=x" for a in required]))
    assert set(ours) == set(ref) | own
    for name, default in ref.items():
        if name in moved:
            continue
        want = "x" if name in required else default
        assert ours[name] == want, name
    if script == "train_flownetc_highres.py":
        assert ours["report"] == "results/torch/flownetc_highres.json"


@pytest.mark.parametrize("net", ["C", "S"])
def test_train_flownetc_end_to_end(tmp_path, net):
    """A few steps on the CPU: the report has the script's keys, the
    weights file loads into JAX's net, and JAX's EPE of those weights on
    the same held-out corpus is the report's."""
    from flax import serialization

    import ode_rl_tpu.flow.flownets as jax_flownets
    from ode_rl_tpu.flow import data as jax_data

    report = train_flownetc.main([
        "--net", net, "--steps", "2", "--batch", "2", "--val_pairs", "4",
        "--device", "cpu", "--flow_dir", str(tmp_path / "flow"),
        "--report", str(tmp_path / "report.json")])
    assert set(report) == _script_report_keys("train_flownetc.py") | {
        "device"}
    assert json.loads((tmp_path / "report.json").read_text()) == report
    assert report["params_path"] == str(
        tmp_path / "flow" / f"flownet{net.lower()}.msgpack")
    assert report["val_pairs_evaluated"] == 4
    assert np.isfinite(report["val_epe_trained"])
    flax_net = {"C": jax_flownets.FlowNetC, "S": jax_flownets.FlowNetS}[net]()
    shapes = ([(1, 64, 64, 3)] * 2 if net == "C" else [(1, 64, 64, 6)])
    variables = serialization.from_bytes(
        flax_net.init(jax.random.key(0), *[jnp.zeros(s) for s in shapes]),
        pathlib.Path(report["params_path"]).read_bytes())
    val = write_synthetic_chairs(tmp_path / "val", n_pairs=4,
                                 seed=train_flownetc.VAL_SEED)
    epe = jax_data.validate_epe(
        flax_net, variables, jax_data.FlyingChairsCorpus(
            val, batch_size=2, is_train=False, train_split=0.0),
        pair_input=net == "S")
    assert abs(epe / report["val_epe_trained"] - 1.0) <= 1e-5


def test_warm_start_is_the_flownet2_path(tmp_path):
    with pytest.raises(ValueError, match="--net 2"):
        train_flownetc.main(["--net", "C", "--warm_start", "--device", "cpu",
                             "--flow_dir", str(tmp_path)])


def test_train_flownetc_highres_end_to_end(tmp_path):
    """Three steps at 64x64, B=2: the report has the script's keys and
    every step's EPE, and the command raises exactly when the last step's
    EPE is not below the first's."""
    path = tmp_path / "highres.json"
    argv = ["--steps", "3", "--batch", "2", "--height", "64", "--width",
            "64", "--device", "cpu", "--report", str(path)]
    try:
        report = train_flownetc_highres.main(argv)
        fell = True
    except AssertionError as e:
        assert "EPE did not improve" in str(e)
        report, fell = json.loads(path.read_text()), False
    assert set(report) == (_script_report_keys("train_flownetc_highres.py")
                           | {"epe", "device"})
    assert report["resolution"] == "64x64" and len(report["epe"]) == 4
    assert report["epe"][0] == report["first_epe"]
    assert report["epe"][-1] == report["final_epe"]
    assert fell == (report["final_epe"] < report["first_epe"])


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _corpus(root: pathlib.Path) -> None:
    """Both layouts: train/ a shard of 2 videos (N, T, H, W); test/ one
    video (T, H, W) and one (T, H, W, 1); uint8, 5 frames of 64x64."""
    for split in ("train", "test"):
        (root / split).mkdir(parents=True)
    u8 = lambda v: np.round((v + 0.5) * 255).astype(np.uint8)[..., 0]
    np.save(root / "train" / "shard_0000.npy", u8(_mmnist(7, 2, 5)))
    np.save(root / "test" / "video_0000.npy", u8(_mmnist(8, 1, 5))[0])
    np.save(root / "test" / "video_0001.npy",
            u8(_mmnist(9, 1, 5))[0][..., None])


def _port_label_flow(port, video01: np.ndarray) -> np.ndarray:
    """The port's label flow (the finest flow resized x4) of each
    transition, (B, T-1, H, W, 2); within 1e-4 of JAX's
    (tests/test_torch_port_flow_labels.py)."""
    b, t, h, w, _ = video01.shape
    img = t32(video01).expand(-1, -1, -1, -1, 3)
    with torch.no_grad():
        flows = port(img[:, :-1].reshape(-1, h, w, 3),
                     img[:, 1:].reshape(-1, h, w, 3))
        full = resize_bilinear(flows[0], h, w) * 4.0
    return np32(full).reshape(b, t - 1, h, w, 2)


def test_label_script_matches_jax_on_both_layouts(tmp_path, monkeypatch,
                                                  capsys):
    """JAX-saved weights; each label file beside its source, (N, T, 9)
    with row 0 zero, equal to the JAX script's on the clear cells; no
    weights: JAX's warning."""
    from ode_rl_tpu.flow.flownets import FlowNetC
    from ode_rl_tpu.flow.train import save_flownet_params as jax_save

    net = FlowNetC()
    dummy = jnp.zeros((1, 64, 64, 3))
    variables = net.init(jax.random.key(5), dummy, dummy)
    params = tmp_path / "flownetc.msgpack"
    jax_save({"params": variables}, params)
    port = flownets.FlowNetC(generator=torch.Generator())
    load_flax(port, variables["params"])
    ours_root, ref_root = tmp_path / "port", tmp_path / "jax"
    _corpus(ours_root)
    _corpus(ref_root)
    written = get_labels_from_pred_flow.main([
        "--data", str(ours_root), "--flownet_params", str(params),
        "--batch_videos", "2", "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", [
        "get_labels_from_pred_flow.py", "--data", str(ref_root),
        "--flownet_params", str(params), "--batch_videos", "2"])
    _jax_script("get_labels_from_pred_flow").main()
    names = sorted(pathlib.Path(p).relative_to(ours_root) for p in written)
    assert [str(n) for n in names] == [
        "test/video_0000_labels.npy", "test/video_0001_labels.npy",
        "train/shard_0000_labels.npy"]
    for name in names:
        ours, ref = np.load(ours_root / name), np.load(ref_root / name)
        assert ours.shape == ref.shape and ours.dtype == ref.dtype
        assert ours.shape[1:] == (5, 9) and not ours[:, 0].any()
        src = np.load(ours_root / str(name).replace("_labels", ""))
        video = src.reshape(-1, 5, 64, 64, 1).astype(np.float32) / 255.0
        clear = _clear(_port_label_flow(port, video))
        np.testing.assert_array_equal(ours[:, 1:][clear], ref[:, 1:][clear])
    capsys.readouterr()
    get_labels_from_pred_flow.main(["--data", str(ours_root), "--splits",
                                    "test", "--device", "cpu"])
    assert "warning: no trained FlowNetC params" in capsys.readouterr().out
