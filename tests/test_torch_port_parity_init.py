"""The matched-step parity bridge: one JAX init for both packages' runs.

``tests/torch_port_parity_init.py`` writes JAX's step-0 checkpoint and
the params' ``.npz``; ``python -m ode_rl_torch.parity_init`` writes the
port's step-0 checkpoint from that ``.npz``. Each package's ``main`` then
resumes from its own at step 0. Held here, for the ConvGRU twin
(``results/port_parity``) and for the recipe, ODE-ConvGRU
(``results/port_parity/recipe``): one step of both ``main``s at narrow
widths (the same first batch bit for bit, the same loss and NFE), the
committed full-width ``.npz`` through the bridge (the loss on ``main``'s
first batch of the parity corpus against JAX's, and against JAX's
recorded step 1), and the committed results of the matched-step runs
(finite, complete, at one step N, the recipe's ODE solves recorded, and
the Δ% of ``summary.json``, which PERF.md gives).
"""

import ast
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_parity_init as jax_init
from ode_rl_torch import make_frozen_mmnist, parity_compare, parity_init
from ode_rl_torch.data.mmnist import parse_datasets
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.main import main as port_main
from ode_rl_torch.train import loop as port_loop
from ode_rl_torch.train.step import restore_model

REPO = pathlib.Path(__file__).resolve().parents[1]
RESULTS = REPO / "results" / "port_parity"
CGRU = ("defaults", "train_mmnist_cgru_len20")
RECIPE = ("defaults", "train_mmnist_odecgru_len20_1ch")
# Each model: its config blocks, narrow widths (batch 2), its committed
# init and results, its eval horizons, its run directory's model name,
# its width's config key and whether its evaluation records ODE solves.
MODELS = {
    "twin": dict(blocks=CGRU, narrow=("--conv_encoder_out_ch", "16",
                                      "--convgru_out_ch", "16",
                                      "--batch_size", "2"),
                 init="convgru_init.npz", results=RESULTS, outs=(10, 190),
                 model="ConvGRU", width="convgru_out_ch", ode=False),
    "recipe": dict(blocks=RECIPE, narrow=("--conv_encoder_out_ch", "16",
                                          "--neural_ode_decoder_out_ch", "16",
                                          "--neural_ode_n_units", "16",
                                          "--n_ode_layers", "1",
                                          "--batch_size", "2"),
                   init="odecgru_init.npz", results=RESULTS / "recipe",
                   outs=(10, 90), model="ODEConv",
                   width="neural_ode_decoder_out_ch", ode=True),
}
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


@pytest.mark.parametrize("which", MODELS)
def test_one_step_of_each_main_from_one_init(which, corpus, tmp_path,
                                             monkeypatch):
    from main import get_cfg as jax_cfg
    from ode_rl_tpu.train import loop as jax_loop

    spec = MODELS[which]

    def argv(side):
        return ["--configs", *spec["blocks"], *spec["narrow"], "--frozen",
                "True", "--data_dir", str(corpus), "--logdir",
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
    assert got.get("nfe") == want.get("nfe")


def _chip_smoke_constant(name: str):
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == name):
            return ast.literal_eval(node.value)
    raise KeyError(name)


@pytest.fixture(scope="module")
def parity_corpus(tmp_path_factory):
    """The corpus of the parity runs, its bytes held to chip_smoke's."""
    root = tmp_path_factory.mktemp("parity_corpus")
    digests = make_frozen_mmnist.main(
        ["--out", str(root), *_chip_smoke_constant("CORPUS_ARGS")])
    assert digests == _chip_smoke_constant("CORPUS_SHA256")
    return root


@pytest.mark.parametrize("which", MODELS)
def test_committed_init_gives_jax_loss_at_full_width(which, parity_corpus,
                                                     tmp_path):
    """The committed init through the bridge at full width, on the first
    batch ``main`` draws from the parity corpus: the loss of JAX's model
    on the same batch, and JAX's recorded step 1 (``jax_first20``)."""
    from ode_rl_tpu.core.config import load_config as jax_load
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    from ode_rl_tpu.models import build_model as jax_build

    spec = MODELS[which]
    npz = RESULTS / spec["init"]
    parity_init.main(["--params", str(npz), "--configs", *spec["blocks"],
                      "--frozen", "True", "--data_dir", str(parity_corpus),
                      "--logdir", str(tmp_path), "--ckpt_id", "full",
                      "--device", "cpu"])
    model, cfg, step = restore_model(tmp_path, spec["model"], "full",
                                     torch.device("cpu"))
    assert step == 0 and cfg[spec["width"]] == 64

    # The loop's setup draws one batch and drops it, as JAX's draws its
    # init sample; step 1 trains on the second.
    loader = parse_datasets(cfg, torch.device("cpu"))["train_dataloader"]
    next(loader)
    video = next(loader)
    with torch.no_grad():
        loss, _ = model.loss(make_batch_dict(video, cfg.train_in_seq), None)

    jcfg = jax_load(list(spec["blocks"]))
    params = jax.tree_util.tree_map(jnp.asarray, parity_init.read_params(npz))
    jmodel = jax_build(jcfg)
    want, _ = jax.jit(lambda p, b: jmodel.apply(
        {"params": p}, b, train=True, method=jmodel.loss))(
        params, jax_batch(jnp.asarray(video.numpy()),
                          n_in=jcfg.train_in_seq))
    assert abs(float(loss) / float(want) - 1) <= LOSS_RTOL
    first = json.loads((spec["results"] / "jax_first20" / "train_metrics.jsonl")
                       .read_text().splitlines()[0])
    assert first["step"] == 1
    assert abs(float(loss) / first["loss"] - 1) <= LOSS_RTOL


RUNS = ("jax", "port", "port_noise")


def _runs(which) -> dict:
    return {name: parity_compare.read_run(MODELS[which]["results"] / name)
            for name in RUNS}


@pytest.mark.parametrize("which", MODELS)
@pytest.mark.parametrize("name", RUNS)
def test_committed_results_are_whole(which, name):
    spec = MODELS[which]
    run = _runs(which)[name]
    record = json.loads((spec["results"] / name / "run.json").read_text())
    n_steps = record["steps"]
    jax_steps = json.loads((spec["results"] / "jax" / "run.json")
                           .read_text())["steps"]
    assert n_steps == jax_steps and n_steps % 250 == 0 and n_steps <= 2000
    outs = ",".join(map(str, spec["outs"]))
    commands = " ".join(record["commands"].values())
    assert "--eval_videos 64" in commands and f"--eval_outs {outs}" in commands
    assert run["metrics"]["step"] == n_steps
    for n_out in spec["outs"]:
        for metric in ("mse", "psnr", "ssim"):
            values = np.asarray(run["metrics"][f"10to{n_out}"][metric])
            assert values.shape == (n_out,) and np.all(np.isfinite(values))
    assert set(range(500, n_steps + 1, 500)) <= set(run["losses"])
    assert all(np.isfinite(v) for v in run["losses"].values())
    if spec["ode"]:
        ode = json.loads((spec["results"] / name / "ode.json").read_text())
        assert set(ode) == {f"10to{n}" for n in spec["outs"]}
        for solves in ode.values():
            assert 0 < solves["max_accepted"] <= solves["max_attempts"] <= 128


@pytest.mark.parametrize("which", MODELS)
def test_committed_deltas_match_summary(which):
    runs = _runs(which)
    summary = json.loads((MODELS[which]["results"] / "summary.json")
                         .read_text())
    perf = (REPO / "PERF.md").read_text()
    for label, (a, b) in {"port against jax": ("port", "jax"),
                          "port_noise against jax": ("port_noise", "jax"),
                          "port_noise against port": ("port_noise", "port")
                          }.items():
        row = parity_compare.compare(runs[a], runs[b])
        assert row == summary[label]
        assert row["step"] == [runs[a]["metrics"]["step"]] * 2
        assert f"{row['delta_pct']['10to10']:+.3f}%" in perf, label


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
