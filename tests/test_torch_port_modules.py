"""Modules of the PyTorch port against their flax/JAX counterparts, with
flax's weights converted by ``ode_rl_torch.convert``: the conv stacks, the
ConvGRU cell, the ODE-ConvGRU encoder, dense output, the dopri5 pieces,
``odeint_fast``, the Moving MNIST generator and the flagship config.

Small shapes (batch 2, 8x8 latents, 64 channels so GroupNorm groups stay
above one). Tolerances: single modules 2e-5 max abs on outputs and
2e-5 relative L2 on gradient leaves (a leaf sums hundreds of products);
``odeint_fast`` 1e-4 max abs on outputs, equal stats, 1e-3 relative L2
on gradients.
"""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (assert_grads_close, load_flax, max_abs, np32,
                             rel_l2, t32)
from ode_rl_torch.nn.conv_stacks import ConvDecoder, ConvEncoder, ConvNet
from ode_rl_torch.nn.convgru import ConvGRUCell
from ode_rl_torch.nn.odeconvgru import ODEConvGRUEncoder

TOL = 2e-5
C = 64


def _gen():
    return torch.Generator().manual_seed(0)


def _module_parity(flax_module, port_module, inputs, extra=()):
    """Outputs and gradients (inputs and every parameter leaf) of
    sum(outputs * w) for random w, flax vs port."""
    variables = flax_module.init(jax.random.key(0),
                                 *[jnp.asarray(a) for a in inputs], *extra)
    load_flax(port_module, variables["params"])

    j_outs = flax_module.apply(variables, *[jnp.asarray(a) for a in inputs],
                               *extra)
    j_outs = j_outs if isinstance(j_outs, tuple) else (j_outs,)
    rng = np.random.RandomState(7)
    weights = [rng.randn(*o.shape).astype(np.float32) for o in j_outs]

    def loss(params, *xs):
        outs = flax_module.apply({"params": params}, *xs, *extra)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights))

    j_grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(inputs) + 1))))(
        variables["params"], *[jnp.asarray(a) for a in inputs])

    leaves = [t32(a).requires_grad_(True) for a in inputs]
    t_extra = [None if e is None else t32(e) for e in extra]
    t_outs = port_module(*leaves, *t_extra)
    t_outs = t_outs if isinstance(t_outs, tuple) else (t_outs,)
    sum(torch.sum(o * t32(w)) for o, w in zip(t_outs, weights)).backward()

    for a, b in zip(t_outs, j_outs):
        assert max_abs(a, b) <= TOL
    for leaf, g in zip(leaves, j_grads[1:]):
        assert max_abs(leaf.grad, g) <= TOL
    assert_grads_close(port_module, j_grads[0], TOL)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_conv_encoder_matches_flax():
    from ode_rl_tpu.nn.conv_stacks import ConvEncoder as FlaxEncoder

    _module_parity(FlaxEncoder(out_ch=C, n_downs=2),
                   ConvEncoder(1, C, n_downs=2, generator=_gen()),
                   [_rand(2, 32, 32, 1)])


def test_conv_decoder_matches_flax():
    """flax's 'SAME' ConvTranspose is torch's with the kernel flipped."""
    from ode_rl_tpu.nn.conv_stacks import ConvDecoder as FlaxDecoder

    _module_parity(FlaxDecoder(out_ch=1, n_ups=2),
                   ConvDecoder(C, 1, n_ups=2, generator=_gen()),
                   [_rand(2, 8, 8, C)])


def test_convnet_matches_flax():
    from ode_rl_tpu.nn.conv_stacks import ConvNet as FlaxConvNet

    _module_parity(FlaxConvNet(out_ch=C, n_layers=3, n_units=C),
                   ConvNet(C, C, n_layers=3, n_units=C, generator=_gen()),
                   [_rand(2, 8, 8, C)])


@pytest.mark.parametrize("masked", [False, True])
def test_convgru_cell_matches_flax(masked):
    from ode_rl_tpu.nn.convgru import ConvGRUCell as FlaxCell

    mask = (np.array([1.0, 0.0], np.float32),) if masked else ()
    _module_parity(FlaxCell(hidden_dim=C, gate_impl="xla"),
                   ConvGRUCell(C, C, generator=_gen()),
                   [np.tanh(_rand(2, 8, 8, C, seed=1)), _rand(2, 8, 8, C)],
                   extra=mask)


def test_odeconvgru_encoder_matches_flax():
    """Reversed frames, dt = [-0.01, reversed spacing], (mu, |std|)."""
    from ode_rl_tpu.nn.odeconvgru import ODEConvGRUEncoder as FlaxEncoder

    class MuStd(FlaxEncoder):   # the port drops the unused latents
        def __call__(self, xs, ts):
            return super().__call__(xs, ts)[:2]

    ts = (np.arange(4, dtype=np.float32) / 8.0,)
    _module_parity(MuStd(ch=C, ode_n_layers=3, ode_n_units=C),
                   ODEConvGRUEncoder(C, ode_n_layers=3, ode_n_units=C,
                                     generator=_gen()),
                   [_rand(2, 4, 8, 8, C)], extra=ts)


def _field_jax(t, y):
    return -0.8 * y + jnp.sin(3.0 * y) * jnp.cos(2.0 * t)


def _field_torch(t, y):
    t = torch.as_tensor(t, dtype=torch.float32)
    return -0.8 * y + torch.sin(3.0 * y) * torch.cos(2.0 * t)


def test_interp_matches_jax():
    from ode_rl_tpu.ode import interp as jinterp
    from ode_rl_torch.ode import interp

    arrays = [_rand(2, 3, 4, seed=s) for s in range(5)]
    dt = np.float32(0.37)
    j_coeffs = jinterp.interp_fit(*[jnp.asarray(a) for a in arrays], dt)
    t_coeffs = interp.interp_fit(*[t32(a) for a in arrays], float(dt))
    for th in np.linspace(0, 1, 5, dtype=np.float32):
        assert max_abs(interp.interp_eval(t_coeffs, float(th)),
                       jinterp.interp_eval(j_coeffs, th)) <= TOL


def test_dopri5_step_and_initial_step_match_jax():
    from ode_rl_tpu.ode import solvers as jsolvers
    from ode_rl_torch.ode import solvers

    y = _rand(2, 3, 4)
    t, dt = np.float32(0.25), np.float32(0.1)
    j = jsolvers._dopri5_step(_field_jax, jnp.float32(t), jnp.asarray(y),
                              _field_jax(t, jnp.asarray(y)), jnp.float32(dt))
    p = solvers._dopri5_step(_field_torch, t, t32(y),
                             _field_torch(t, t32(y)), dt)
    for a, b in zip(p, j):
        assert max_abs(a, b) <= TOL

    h_j = jsolvers._initial_step(_field_jax, jnp.float32(t), jnp.asarray(y),
                                 _field_jax(t, jnp.asarray(y)), 1e-4, 1e-5)
    h_p = solvers._initial_step(_field_torch, t, t32(y),
                                _field_torch(t, t32(y)), 1e-4, 1e-5)
    assert abs(float(h_p) / float(h_j) - 1.0) <= 1e-5
    # The error estimate is a difference of nearly equal stage sums, so
    # ulp-level differences in the stages show up magnified in the ratio.
    ratio_j = jsolvers._error_ratio(j[2], jnp.asarray(y), j[0], 1e-4, 1e-5)
    ratio_p = solvers._error_ratio(p[2], t32(y), p[0], 1e-4, 1e-5)
    assert abs(float(ratio_p) / float(ratio_j) - 1.0) <= 1e-3


def _osc(m, t, y, p):
    return p["a"] * m.cos(p["w"] * t) * y


# name -> (solver kw, expected (naccept, nreject, converged)). All three
# reject steps; two run out of their step budget, so their unreached output
# slots take the final state. A truncated solve ends where the controller
# stops, so its outputs move with fp32 noise in the error estimate: these
# tolerances keep that estimate far above fp32 resolution.
_CASES = {
    "rejects": (dict(rtol=1e-3, atol=1e-5, max_steps=64), (7, 4, True)),
    "truncated": (dict(rtol=1e-3, atol=1e-5, max_steps=5), (3, 2, False)),
    "truncated_early": (dict(rtol=1e-4, atol=1e-6, max_steps=3),
                        (2, 1, False)),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_odeint_fast_matches_jax(name):
    """Outputs, stats and gradients of the O(NFE) solver; includes the
    unreached-slot fill and its backward."""
    from ode_rl_tpu.ode.fast import odeint_fast as jax_fast
    from ode_rl_torch.ode.fast import odeint_fast

    kw, expected = _CASES[name]
    params = {"a": 4.0, "w": 12.0}
    ts = np.linspace(0.0, 1.0, 9, dtype=np.float32)
    y0 = np.random.RandomState(0).uniform(0.2, 0.8, (2, 3, 4)).astype(
        np.float32)
    w = np.random.RandomState(1).randn(len(ts), 2, 3, 4).astype(np.float32)

    def jax_loss(y0, p):
        ys, stats = jax_fast(lambda t, y, q: _osc(jnp, t, y, q), y0,
                             jnp.asarray(ts), p, **kw)
        return jnp.sum(ys * w), (ys, stats)

    j_params = {k: jnp.float32(v) for k, v in params.items()}
    (_, (j_ys, j_stats)), j_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(y0), j_params)

    t_y0 = t32(y0).requires_grad_(True)
    t_params = {k: torch.tensor(v, requires_grad=True)
                for k, v in params.items()}
    ys, stats = odeint_fast(
        lambda t, y, q: _osc(torch, float(t), y, q),
        t_y0, ts, t_params, **kw)
    torch.sum(ys * t32(w)).backward()

    assert max_abs(ys, j_ys) <= 1e-4
    assert (stats.naccept, stats.nreject, stats.converged) == expected
    assert (stats.nfe, stats.naccept, stats.nreject, stats.converged) == (
        int(j_stats.nfe), int(j_stats.naccept), int(j_stats.nreject),
        bool(j_stats.converged))
    assert rel_l2(t_y0.grad, j_grads[0]) <= 1e-3
    for k in params:
        assert rel_l2(t_params[k].grad, j_grads[1][k]) <= 1e-3


def test_odeint_fast_single_time_returns_y0():
    from ode_rl_torch.ode.fast import odeint_fast

    y0 = torch.ones(2, 3)
    ys, stats = odeint_fast(lambda t, y, p: y, y0, np.zeros(1), {})
    assert ys.shape == (1, 2, 3) and stats.converged and stats.nfe == 0


# ------------------------------ data --------------------------------------

def test_procedural_sprite_bank_equals_jax():
    from ode_rl_tpu.data.sprites import get_sprite_bank as jax_bank
    from ode_rl_torch.data.sprites import get_sprite_bank

    np.testing.assert_array_equal(get_sprite_bank(None), jax_bank(None))


def test_mnist_file_loader_equals_jax(tmp_path):
    from ode_rl_tpu.data.sprites import get_sprite_bank as jax_bank
    from ode_rl_torch.data.sprites import get_sprite_bank

    digits = np.random.RandomState(0).randint(0, 256, (5, 28, 28)).astype(
        np.uint8)
    with gzip.open(tmp_path / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(bytes(16) + digits.tobytes())
    np.testing.assert_array_equal(get_sprite_bank(tmp_path, max_sprites=3),
                                  jax_bank(tmp_path, max_sprites=3))
    np.testing.assert_array_equal(get_sprite_bank(tmp_path), digits)


def test_placement_from_jax_positions_reproduces_jax_video():
    from ode_rl_tpu.data.mmnist import generate_moving_mnist_labeled
    from ode_rl_tpu.data.sprites import get_sprite_bank
    from ode_rl_torch.data.mmnist import render_moving_mnist

    bank = get_sprite_bank(None)
    video, idx, pos = generate_moving_mnist_labeled(
        jax.random.key(3), jnp.asarray(bank), batch=3, n_frames=6,
        num_digits=3)
    ours = render_moving_mnist(torch.from_numpy(bank),
                               torch.from_numpy(np.array(idx)),
                               torch.from_numpy(np.array(pos)))
    assert ours.shape == video.shape
    assert max_abs(ours, video) <= 1e-6


def test_trajectories_match_jax_on_shared_draws():
    """The same (x0, y0, theta) through both formulas: sin/cos ulps can
    cross an integer boundary, so allow 1% of positions one pixel off."""
    from ode_rl_tpu.data.mmnist import _trajectories as jax_traj
    from ode_rl_torch.data.mmnist import _trajectories

    def draws(k):   # the draws _trajectories makes from its key
        k1, k2, k3 = jax.random.split(k, 3)
        return (jax.random.uniform(k1), jax.random.uniform(k2),
                jax.random.uniform(k3) * 2.0 * jnp.pi)

    keys = jax.random.split(jax.random.key(11), 512)
    x0, y0, theta = (t32(a) for a in jax.vmap(draws)(keys))
    ref = np.asarray(jax.vmap(lambda k: jax_traj(k, 20))(keys))
    diff = np.abs(_trajectories(x0, y0, theta, 20).numpy() - ref)
    assert diff.max() <= 1
    assert np.mean(diff == 0) >= 0.99


def test_generator_makes_valid_videos():
    from ode_rl_torch.data.mmnist import generate_moving_mnist
    from ode_rl_torch.data.protocol import make_batch_dict

    bank = torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, (4, 28, 28))).float()
    video = generate_moving_mnist(torch.Generator().manual_seed(0), bank,
                                  batch=2, n_frames=5, num_digits=3)
    assert video.shape == (2, 5, 64, 64, 1)
    assert float(video.min()) >= -0.5 and float(video.max()) <= 0.5
    batch = make_batch_dict(video, n_in=3)
    np.testing.assert_allclose(np32(batch["observed_tp"]), [0, 0.2, 0.4])
    np.testing.assert_allclose(np32(batch["tp_to_predict"]), [0.6, 0.8],
                               rtol=1e-6)
    assert batch["data_to_predict"].shape == (2, 2, 64, 64, 1)


# ------------------------------ config ------------------------------------

def test_flagship_config_equals_yaml_blocks():
    import dataclasses

    from ode_rl_tpu.core.config import load_config
    from ode_rl_torch.config import FlagshipConfig

    yaml_cfg = load_config(["defaults", "tpu_bench_odecgru"]).to_dict()
    for field in dataclasses.fields(FlagshipConfig):
        assert field.name in yaml_cfg, field.name
        assert getattr(FlagshipConfig(), field.name) == yaml_cfg[field.name], \
            field.name
