"""The matched-step parity bridge: one JAX init for both packages' runs.

``tests/torch_port_parity_init.py`` writes JAX's step-0 checkpoint and
the params' ``.npz``; ``python -m ode_rl_torch.parity_init`` writes the
port's step-0 checkpoint from that ``.npz``. Each package's ``main`` then
resumes from its own at step 0. Held here: one step of both ``main``s at
narrow widths (the same first batch bit for bit, the same loss), the
committed full-width ``.npz`` through the bridge (the same loss on one
corpus batch), and the committed results of the 2000-step runs (finite,
complete, and the Δ% of ``summary.json``, which PERF.md cites).
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_parity_init as jax_init
from ode_rl_torch import make_frozen_mmnist, parity_compare, parity_init
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.main import main as port_main
from ode_rl_torch.train import loop as port_loop
from ode_rl_torch.train.step import restore_model

REPO = pathlib.Path(__file__).resolve().parents[1]
RESULTS = REPO / "results" / "port_parity"
CGRU = ("defaults", "train_mmnist_cgru_len20")
NARROW = ("--conv_encoder_out_ch", "16", "--convgru_out_ch", "16",
          "--batch_size", "2")
# One train step, or one loss, of the port against JAX from the same
# parameters and batch: the CPU reads up to about 1e-6 relative.
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity") / "corpus"
    make_frozen_mmnist.main(["--out", str(root), "--videos", "4", "--frames",
                             "24", "--shard_size", "2", "--train_split",
                             "0.5"])
    return root


def _as_numpy(batch) -> dict:
    return {k: np.array(v) for k, v in batch.items() if v is not None}


def _recording(factory, seen: list):
    """``factory`` (a make_train_step) whose steps record their batches."""

    def make(*args, **kwargs):
        step = factory(*args, **kwargs)

        def recorded(state, batch, *rest):
            seen.append(_as_numpy(batch))
            return step(state, batch, *rest)

        return recorded

    return make


def test_one_step_of_each_main_from_one_init(corpus, tmp_path, monkeypatch):
    from main import get_cfg as jax_cfg
    from ode_rl_tpu.train import loop as jax_loop

    def argv(side):
        return ["--configs", *CGRU, *NARROW, "--frozen", "True",
                "--data_dir", str(corpus), "--logdir",
                str(tmp_path / side), "--ckpt_id", f"parity_{side}",
                "--quiet", "True"]

    npz = tmp_path / "init.npz"
    jax_ckpt = jax_init.write_jax_init(argv("jax"), npz)
    assert jax_ckpt.name == "parity_jax_0000000000.ckpt"
    port_ckpt = parity_init.main(["--params", str(npz), *argv("port"),
                                  "--device", "cpu"])
    assert port_ckpt.name == "parity_port_0000000000.ckpt"
    with pytest.raises(FileExistsError):
        parity_init.main(["--params", str(npz), *argv("port"),
                          "--device", "cpu"])

    one = ["--steps_per_epoch", "1", "--epochs", "1"]
    jax_seen, port_seen = [], []
    monkeypatch.setattr(jax_loop, "make_train_step",
                        _recording(jax_loop.make_train_step, jax_seen))
    monkeypatch.setattr(port_loop, "make_train_step",
                        _recording(port_loop.make_train_step, port_seen))
    want = jax_loop.train(jax_cfg([*argv("jax"), *one]))
    got = port_main([*argv("port"), *one, "--device", "cpu"])

    assert want["final_step"] == got["final_step"] == 1
    (jax_batch,), (port_batch,) = jax_seen, port_seen
    assert set(jax_batch) == set(port_batch)
    for k in jax_batch:
        np.testing.assert_array_equal(port_batch[k], jax_batch[k], err_msg=k)
    assert abs(got["loss"] / want["loss"] - 1) <= LOSS_RTOL
    assert abs(got["grad_norm"] / want["grad_norm"] - 1) <= LOSS_RTOL


def test_committed_init_gives_jax_loss_at_full_width(corpus, tmp_path):
    from ode_rl_tpu.core.config import load_config as jax_load
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    from ode_rl_tpu.models import build_model as jax_build

    npz = RESULTS / "convgru_init.npz"
    parity_init.main(["--params", str(npz), "--configs", *CGRU,
                      "--logdir", str(tmp_path), "--ckpt_id", "full",
                      "--device", "cpu"])
    model, cfg, step = restore_model(tmp_path, "ConvGRU", "full",
                                     torch.device("cpu"))
    assert step == 0 and cfg.convgru_out_ch == 64

    video = np.load(corpus / "train" / "shard_0000.npy")[:, :20]
    video = np.concatenate([video, video])[:cfg.batch_size]
    video = video.astype(np.float32)[..., None] / 255.0 - 0.5
    with torch.no_grad():
        loss, _ = model.loss(make_batch_dict(torch.from_numpy(video),
                                             cfg.train_in_seq), None)

    jcfg = jax_load(list(CGRU))
    params = jax.tree_util.tree_map(jnp.asarray, parity_init.read_params(npz))
    jmodel = jax_build(jcfg)
    want, _ = jmodel.apply(
        {"params": params}, jax_batch(jnp.asarray(video),
                                      n_in=jcfg.train_in_seq),
        train=True, method=jmodel.loss)
    assert abs(float(loss) / float(want) - 1) <= LOSS_RTOL


def _runs() -> dict:
    return {name: parity_compare.read_run(RESULTS / name)
            for name in ("jax", "port", "port_noise")}


@pytest.mark.parametrize("name", ["jax", "port", "port_noise"])
def test_committed_results_are_whole(name):
    run = _runs()[name]
    record = json.loads((RESULTS / name / "run.json").read_text())
    commands = " ".join(record["commands"].values())
    assert "--eval_videos 64" in commands and "--eval_outs 10,190" in commands
    assert run["metrics"]["step"] == 2000
    for key, n in (("10to10", 10), ("10to190", 190)):
        for metric in ("mse", "psnr", "ssim"):
            values = np.asarray(run["metrics"][key][metric])
            assert values.shape == (n,) and np.all(np.isfinite(values))
    assert {500, 1000, 2000} <= set(run["losses"])
    assert all(np.isfinite(v) for v in run["losses"].values())


def test_committed_deltas_match_summary():
    runs = _runs()
    summary = json.loads((RESULTS / "summary.json").read_text())
    for label, (a, b) in {"port against jax": ("port", "jax"),
                          "port_noise against jax": ("port_noise", "jax"),
                          "port_noise against port": ("port_noise", "port")
                          }.items():
        assert parity_compare.compare(runs[a], runs[b],
                                      parity_compare.STEPS) == summary[label]


def test_noise_init_is_the_bridged_init_times_seeded_noise(tmp_path):
    def params(ckpt_id, *noise):
        parity_init.main(["--params", str(RESULTS / "convgru_init.npz"),
                          "--configs", *CGRU, "--logdir", str(tmp_path),
                          "--ckpt_id", ckpt_id, "--device", "cpu", *noise])
        model, _, _ = restore_model(tmp_path, "ConvGRU", ckpt_id,
                                    torch.device("cpu"))
        return {n: p.detach() for n, p in model.named_parameters()}

    base, noisy = params("base"), params("a", "--noise", "1e-7")
    again = params("b", "--noise", "1e-7")
    ratio = torch.cat([(noisy[n] / base[n] - 1).flatten() for n in base
                       if base[n].abs().min() > 0])
    assert 0.5e-7 < float(ratio.std()) < 2e-7
    for name in base:
        assert torch.equal(noisy[name], again[name]), name
