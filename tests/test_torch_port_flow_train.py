"""The FlowNet training slice of the PyTorch port against the JAX package:
the 'digits' supervision generator on given sprite indices and positions,
one FlowNetC training step at the bench geometry (d = 20, stride 2) in
fp32 at B=2 from converted weights (loss, EPE and the parameters after
Adam), the single-scale step, the fused step and the training run on the
CPU, and the two FlowNet configurations against their sources.

Tolerances: datagen exact (the images to one ulp: XLA divides by 255 as
a multiply by its reciprocal); loss and EPE 1e-5 relative; the first Adam
update 1e-3 relative L2 on the entries whose gradient exceeds 1e-6 (below
that, lr * g / (|g| + eps) flips with fp32 noise).
"""

import ast
import dataclasses
import inspect
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_flax, max_abs, np32, rel_l2, t32
from ode_rl_torch.config import FlowNet2Config, FlowNetCBenchConfig
from ode_rl_torch.convert import flax_to_torch
from ode_rl_torch.data.mmnist import (generate_moving_mnist_per_digit,
                                      render_per_digit)
from ode_rl_torch.flow import flownets
from ode_rl_torch.flow.train import (flow_batch_from_digits,
                                     make_flow_train_step,
                                     make_fused_flow_train_step,
                                     synthetic_flow_batch, train_flownet)
from ode_rl_torch.ops import common

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def bank():
    from ode_rl_tpu.data.sprites import get_sprite_bank

    return get_sprite_bank(None)


def _jax_batch(bank, seed, batch):
    from ode_rl_tpu.flow.train import synthetic_flow_batch as jax_batch

    return [np.asarray(a) for a in jax_batch(jax.random.key(seed),
                                             jnp.asarray(bank), batch=batch)]


def test_digits_batch_matches_jax_on_given_draws(bank):
    """JAX's per-digit canvases, indices and positions through the port's
    renderer and flow labels reproduce JAX's (img1, img2, flow)."""
    from ode_rl_tpu.data.mmnist import generate_moving_mnist_per_digit as gen

    key = jax.random.key(5)
    per, idx, pos = (np.array(a) for a in gen(key, jnp.asarray(bank),
                                                batch=4, n_frames=2,
                                                num_digits=3))
    ours = render_per_digit(torch.from_numpy(bank), torch.from_numpy(idx),
                            torch.from_numpy(pos))
    np.testing.assert_array_equal(ours.numpy(), per)
    img1, img2, flow = flow_batch_from_digits(ours, torch.from_numpy(pos))
    j_img1, j_img2, j_flow = _jax_batch(bank, 5, 4)
    assert max_abs(img1, j_img1) <= 6e-8 and max_abs(img2, j_img2) <= 6e-8
    np.testing.assert_array_equal(flow.numpy(), j_flow)


def test_synthetic_flow_batch_from_a_torch_generator(bank):
    gen = torch.Generator().manual_seed(0)
    img1, img2, flow = synthetic_flow_batch(gen, torch.from_numpy(bank),
                                            batch=3)
    assert img1.shape == img2.shape == (3, 64, 64, 3)
    assert flow.shape == (3, 64, 64, 2)
    assert float(img1.min()) >= 0.0 and float(img1.max()) <= 1.0
    assert torch.equal(flow, flow.round())
    assert torch.all(flow[img1[..., 0] == 0] == 0)
    per, idx, pos = generate_moving_mnist_per_digit(
        torch.Generator().manual_seed(0), torch.from_numpy(bank), batch=2,
        n_frames=2)
    assert per.shape == (2, 3, 2, 64, 64) and idx.shape == (2, 3)
    assert pos.shape == (2, 3, 2, 2)
    with pytest.raises(NotImplementedError):
        synthetic_flow_batch(gen, torch.from_numpy(bank), style="smooth")


@pytest.fixture(scope="module")
def flownetc_step(bank):
    """One JAX train step of FlowNetC (d = 20, stride 2) at B=2, fp32, on a
    digits batch, and its initial params."""
    from ode_rl_tpu.flow.flownets import FlowNetC
    from ode_rl_tpu.flow.train import make_flow_train_step as jax_step

    img1, img2, flow = _jax_batch(bank, 7, 2)
    init_fn, step_fn = jax_step(FlowNetC())
    state = init_fn(jax.random.key(1), (jnp.asarray(img1),
                                        jnp.asarray(img2)))
    params = jax.tree_util.tree_map(np.asarray, state["params"]["params"])
    new_state, metrics = step_fn(state, (jnp.asarray(img1),
                                         jnp.asarray(img2)),
                                 jnp.asarray(flow))
    return dict(batch=(img1, img2, flow), params=params,
                new_params=new_state["params"]["params"],
                metrics={k: float(v) for k, v in metrics.items()})


def test_flownetc_train_step_matches_jax(flownetc_step):
    """The slice as a whole: loss, EPE and the parameters after Adam."""
    img1, img2, flow = flownetc_step["batch"]
    model = flownets.FlowNetC(generator=torch.Generator().manual_seed(0))
    load_flax(model, flownetc_step["params"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    init_fn, step_fn = make_flow_train_step(model)
    state = init_fn()
    metrics = step_fn(state, (t32(img1), t32(img2)), t32(flow))
    for key in ("loss", "epe"):
        ref = flownetc_step["metrics"][key]
        assert abs(float(metrics[key]) / ref - 1.0) <= 1e-5, key
    assert state.step == 1 and float(metrics["grad_norm"]) > 0
    ref_after = flax_to_torch(jax.tree_util.tree_map(
        np.asarray, flownetc_step["new_params"]))
    for name, p in model.named_parameters():
        big = np.abs(np32(p.grad)) > 1e-6
        ours = np32(p - before[name])[big]
        ref = np32(ref_after[name] - before[name])[big]
        assert rel_l2(ours, ref) <= 1e-3, name


def test_single_scale_step_matches_jax():
    """FlowNet2's loss path (single full-resolution flow, L1) on the fusion
    net, which returns one flow."""
    from ode_rl_tpu.flow.flownets import FlowNetFusion
    from ode_rl_tpu.flow.train import make_flow_train_step as jax_step

    rng = np.random.RandomState(8)
    x = rng.uniform(0, 1, (2, 16, 16, 11)).astype(np.float32)
    target = rng.randn(2, 16, 16, 2).astype(np.float32)
    init_fn, step_fn = jax_step(FlowNetFusion(), single_scale=True)
    state = init_fn(jax.random.key(2), (jnp.asarray(x),))
    _, j_metrics = step_fn(state, (jnp.asarray(x),), jnp.asarray(target))
    model = flownets.FlowNetFusion(generator=torch.Generator().manual_seed(0))
    load_flax(model, state["params"]["params"])
    t_init, t_step = make_flow_train_step(model, single_scale=True)
    metrics = t_step(t_init(), (t32(x),), t32(target))
    for key in ("loss", "epe"):
        assert abs(float(metrics[key]) / float(j_metrics[key]) - 1) <= 1e-5


def test_fused_step_and_training_run_on_cpu(bank):
    common.reset_launches()
    model = flownets.FlowNetC(generator=torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in model.parameters()]
    init_fn, step_fn = make_fused_flow_train_step(
        model, torch.from_numpy(bank).float(), batch=2)
    state = init_fn()
    metrics = step_fn(state, torch.Generator().manual_seed(0))
    assert set(metrics) == {"loss", "epe", "grad_norm"}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert any(not torch.equal(a, b)
               for a, b in zip(before, model.parameters()))
    out = train_flownet(flownets.FlowNetS(generator=torch.Generator()),
                        steps=1, batch=2)
    assert np.isfinite(out["loss"]) and out["state"].step == 1
    assert all(n == 0 for n in common.launches.values())


# ------------------------------ configs -----------------------------------

def _function_source(path, name):
    tree = ast.parse((REPO / path).read_text())
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _defaults(fn):
    return {k: v.default for k, v in inspect.signature(fn).parameters.items()
            if v.default is not inspect.Parameter.empty}


def test_flownetc_bench_config_equals_bench_py():
    from ode_rl_tpu.flow.flownets import FlowNetC
    from ode_rl_tpu.flow.train import make_fused_flow_train_step as fused

    bench = _function_source("bench.py", "bench_flownetc")
    text = ast.unparse(bench)
    assert "b = 256" in text and "FlowNetC(dtype=jnp.bfloat16)" in text
    cfg = FlowNetCBenchConfig()
    assert (cfg.batch, cfg.dtype) == (256, "bfloat16")
    assert cfg.max_displacement == FlowNetC.max_displacement
    assert cfg.corr_stride == FlowNetC.corr_stride
    step = _defaults(fused)
    assert (cfg.lr, cfg.loss_norm, cfg.single_scale) == (
        step["lr"], step["loss_norm"], step["single_scale"])


def test_flownet2_config_equals_train_script():
    from ode_rl_tpu.flow.flownets import FlowNet2

    main = _function_source("scripts/train_flownetc.py", "main")
    args = {}
    for node in ast.walk(main):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                args[node.args[0].value.lstrip("-")] = ast.literal_eval(
                    kw["default"])
    cfg = FlowNet2Config()
    assert "2" in ast.literal_eval(
        next(k.value for n in ast.walk(main) if isinstance(n, ast.Call)
             and n.args and getattr(n.args[0], "value", "") == "--net"
             for k in n.keywords if k.arg == "choices"))
    assert (cfg.batch, cfg.lr) == (args["batch"], args["lr"])
    assert "single_scale = args.net == '2'" in ast.unparse(main)
    assert cfg.single_scale and cfg.rgb_max == FlowNet2.rgb_max
    assert cfg.dtype == "float32" and cfg.loss_norm == "l1"
    assert dataclasses.replace(cfg, batch=4).batch == 4
