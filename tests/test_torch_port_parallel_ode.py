"""Data parallelism against JAX, the ODE families of
``__graft_entry__.py::dryrun_multichip``: the flagship ODE-ConvGRU at
the dry run's shapes (widths 64, 3 -> 3 frames, B=8, ode_max_steps 32)
and the Vid-ODE GAN's two-optimizer step. Each starts from JAX's init
(``convert.py``) on the same numpy batch; the port's step over 4 gloo
ranks (ode_rl_torch/parallel/dryrun.py, one spawn for the file) is held
to JAX's unsharded step and to the port's one-process step at the dry
run's tolerances: the flagship's loss 1e-5 relative and grad_norm 1e-4;
the GAN's d_loss and g_loss 1e-5 plus 1e-6, and the norms of D's and G's
gradients 1e-4 (JAX's read from its Adamax state after the step). The
NFE is equal and the parameters after the step bit-equal across the
ranks. The GAN runs on 32x32 frames where the dry run's are 64x64: JAX's
step on the CPU takes 45 s at 64x64 after a 19 s init, 10 s at 32x32,
the same program at B=8. ``python -m ode_rl_torch.parallel.dryrun``
runs it at 64x64 against the port's one-process step.

The same spawn runs ``dryrun_multichip``'s dp x tp and dp x sp flagship
steps (``flagship_tp``: a 2 x 2 ('data', 'model') mesh, the 11 wide
kernels' output channels sharded; ``flagship_sp``: a 2 x 2 ('data',
'space') mesh, the frame height sharded) from the flagship's inputs,
held to the same references at the same tolerances, with equal NFE;
the update of their parameters (the 'model' slices gathered) lies within
``PARAM_TOL`` relative L2 of the one-process step's.
"""

import jax
import pytest

from ode_rl_torch.parallel import dryrun
from torch_port_parallel_util import (RANKS, first_step_grad_norm,
                                      load_named, port_weights, run_families,
                                      scalars, tolerance_misses, train_case,
                                      video_batches)

FAMILIES = ("flagship", "gan", "flagship_tp", "flagship_sp")
# dryrun_multichip's dp x tp and dp x sp flagship steps.
AXES = ("flagship_tp", "flagship_sp")


def _flagship():
    from ode_rl_tpu.models.odeconvgru import ODEConvGRUModel
    model = ODEConvGRUModel(in_channels=1, conv_encoder_out_ch=64,
                            neural_ode_decoder_out_ch=64,
                            neural_ode_n_units=64, n_ode_layers=1,
                            ode_max_steps=32)
    return train_case("flagship", model, {"lr": 1e-3, "clip": -1},
                      video_batches(6, 0), load_named)


def _gan():
    from ode_rl_tpu.core.config import Config as JaxConfig
    from ode_rl_tpu.models.vidode import VidODEModel
    from ode_rl_tpu.train.gan import create_gan_state, make_gan_train_step
    jb, pb = video_batches(6, 3, size=32)
    model = VidODEModel(in_channels=1, n_downs=1, n_layers=1,
                        ode_max_steps=16, rtol=1e-3, atol=1e-4)
    state = create_gan_state(model, JaxConfig({"lr": 8e-4,
                                               "lr_decay": 0.99}),
                             jb, jax.random.key(0), steps_per_epoch=10)

    def load(s):
        load_named(s.gen, state.gen_params,
                   state.gen_model_state["batch_stats"])
        load_named(s.disc, state.disc_params)

    # Before the step, which donates the state.
    weights = port_weights("gan", load)
    step = make_gan_train_step(model, extrap=True, lamb_adv=0.003)
    new, metrics = step(state, jb, jax.random.key(1))
    ref = scalars(metrics)
    ref["d_grad_norm"] = first_step_grad_norm(new.disc_opt_state)
    ref["g_grad_norm"] = first_step_grad_norm(new.gen_opt_state)
    return {"weights": weights, "batch": pb}, ref


@pytest.fixture(scope="module")
def runs():
    flagship = _flagship()
    return run_families({"flagship": flagship, "gan": _gan(),
                         **{name: flagship for name in AXES}})


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_step_matches_jax_unsharded(runs, name):
    result, ref = runs[name]
    assert tolerance_misses(name, result["sharded"], ref) == []


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_step_matches_the_one_process_step(runs, name):
    result, _ = runs[name]
    assert tolerance_misses(name, result["sharded"], result["single"]) == []


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_nfe_equals_the_unsharded_nfe(runs, name):
    result, ref = runs[name]
    assert result["sharded"]["nfe"] == result["single"]["nfe"] == int(
        ref["nfe"])


@pytest.mark.parametrize("name", FAMILIES)
def test_parameters_bit_equal_across_ranks(runs, name):
    result, _ = runs[name]
    assert result["params_equal"]
    assert result["grad_bytes"] > 0
    assert len(result["rank_launches"]) == RANKS


@pytest.mark.parametrize("name", AXES)
def test_parameters_after_the_step_match_the_one_process_step(runs, name):
    result, _ = runs[name]
    assert result["update_rel_l2"] <= dryrun.FAMILIES[name]().param_tol
