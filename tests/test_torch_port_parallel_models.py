"""Data parallelism against JAX, the S3VAE and FlowNetC families of
``__graft_entry__.py::dryrun_multichip`` at its shapes: S3VAE (its
negatives and MI across ranks, BatchNorm on global moments) and FlowNetC
(full width, B=8; its correlation's plain versions on the CPU). Each
starts from JAX's init (``convert.py``) on JAX's batch, S3VAE from the
draws the recorder of tests/test_torch_port_s3vae.py takes from JAX's
step. The port's step over 4 gloo ranks (ode_rl_torch/parallel/dryrun.py,
one spawn for the file; each rank draws at the global batch's shapes and
keeps its rows) is held to JAX's unsharded step and to the port's
one-process step at the dry run's tolerances: S3VAE's loss 1e-5
relative; FlowNetC's loss and EPE 1e-5 plus 1e-6; each grad_norm 1e-4
(FlowNetC's against JAX's read from its Adam state after the step). The
parameters after the step are bit-equal across the ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_port_s3vae import Recorder
from torch_port_parallel_util import (RANKS, first_step_grad_norm,
                                      load_named, port_weights,
                                      run_families, scalars,
                                      tolerance_misses, train_state_and_step,
                                      video_batches)

FAMILIES = ("s3vae", "flownetc")
B = 8


def _s3vae():
    from ode_rl_tpu.models.s3vae import S3VAEModel
    jb, pb = video_batches(6, 0, with_flow_labels=True)
    model = S3VAEModel(in_channels=1, d_zf=32, d_zt=8, encoder_out_dims=32,
                       extrapolate=True)
    state, step = train_state_and_step(model, {"lr": 1e-3, "clip": -1}, jb)
    rec = Recorder(seed=5)
    with pytest.MonkeyPatch.context() as mp:
        rec.patch(mp)
        _, metrics = step(state, jb, jax.random.key(1))
    weights = port_weights("s3vae", lambda s: load_named(
        s.model, state.params, state.model_state["batch_stats"]))
    return ({"weights": weights, "batch": pb, "draws": rec.draws},
            scalars(metrics))


def _flownetc():
    from ode_rl_tpu.data.sprites import get_sprite_bank
    from ode_rl_tpu.flow.flownets import FlowNetC
    from ode_rl_tpu.flow.train import make_flow_train_step, \
        synthetic_flow_batch
    img1, img2, flow = synthetic_flow_batch(
        jax.random.key(0), jnp.asarray(get_sprite_bank()), batch=B)
    init_fn, step_fn = make_flow_train_step(FlowNetC())
    state = init_fn(jax.random.key(1), (img1, img2))
    weights = port_weights("flownetc", lambda s: load_named(
        s.model, state["params"]["params"]))
    new, metrics = step_fn(state, (img1, img2), flow)
    ref = scalars(metrics)
    ref["grad_norm"] = first_step_grad_norm(new["opt"])
    batch = {"img1": np.asarray(img1), "img2": np.asarray(img2),
             "flow": np.asarray(flow)}
    return {"weights": weights, "batch": batch}, ref


@pytest.fixture(scope="module")
def runs():
    return run_families({"s3vae": _s3vae(), "flownetc": _flownetc()})


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_step_matches_jax_unsharded(runs, name):
    result, ref = runs[name]
    assert tolerance_misses(name, result["sharded"], ref) == []


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_step_matches_the_one_process_step(runs, name):
    result, _ = runs[name]
    assert tolerance_misses(name, result["sharded"], result["single"]) == []


@pytest.mark.parametrize("name", FAMILIES)
def test_parameters_bit_equal_across_ranks(runs, name):
    result, _ = runs[name]
    assert result["params_equal"]
    assert result["grad_bytes"] > 0
    assert len(result["rank_launches"]) == RANKS
