"""Kernels K5-K8 of the PyTorch port and the FlowNet path's other ops, on
the CPU, against the JAX package: the correlation forward and its two
backward kernels (plain versions), channelnorm and its hand-written
backward, the warps, the bilinear resize and the flow losses.

The same numpy inputs go to both sides. JAX runs the Pallas kernels in
interpret mode (``impl="interpret"``) and its XLA formulas
(``impl="xla"``). Tolerance: 1e-5 max abs in fp32 (sums reassociated
between XLA:CPU and torch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import max_abs, np32, t32
from ode_rl_torch.flow import losses
from ode_rl_torch.ops import common
from ode_rl_torch.ops.channelnorm import channelnorm
from ode_rl_torch.ops.correlation import (correlation, correlation_bwd_f1,
                                          correlation_fwd_plain,
                                          n_displacements)
from ode_rl_torch.ops.resize import resize_bilinear
from ode_rl_torch.ops.warp import grid_sample, resample2d

TOL = 1e-5


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _parity(jax_fn, torch_fn, arrays, tol=TOL):
    """Outputs and input gradients of sum(out * w) for a random w."""
    j_out = jax_fn(*[jnp.asarray(a) for a in arrays])
    w = _rand(*j_out.shape, seed=99)
    j_grads = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * w),
                       argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    leaves = [t32(a).requires_grad_(True) for a in arrays]
    out = torch_fn(*leaves)
    torch.sum(out * t32(w)).backward()
    assert out.shape == j_out.shape
    assert max_abs(out, j_out) <= tol
    for leaf, g in zip(leaves, j_grads):
        assert max_abs(leaf.grad, g) <= tol
    return [leaf.grad for leaf in leaves]


# ----------------------------- correlation --------------------------------

# (d, stride): every window overlapping the 6x9 map (d <= H/2, stride 1),
# the FlowNetC test geometry, and FlowNetC's own d = 20 (d > H).
CORR_CASES = [(2, 1), (4, 2), (20, 2)]


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("d,stride", CORR_CASES)
def test_correlation_matches_jax(d, stride, impl):
    """K5-K7 plain versions through ``CorrelationFn``: forward and both
    gradients against the Pallas custom_vjp in interpret mode and against
    the XLA formula; small C, H != W."""
    from ode_rl_tpu.ops.correlation import correlation as jax_corr

    f1, f2 = _rand(2, 6, 9, 5, seed=1), _rand(2, 6, 9, 5, seed=2)
    _parity(lambda a, b: jax_corr(a, b, d, stride, impl=impl),
            lambda a, b: correlation(a, b, d, stride), [f1, f2])


@pytest.mark.parametrize("d,stride", CORR_CASES)
def test_correlation_backward_matches_autograd_of_plain_forward(d, stride):
    """The K6/K7 plain formulas against autograd of the K5 plain version."""
    f1, f2 = _rand(2, 6, 9, 5, seed=3), _rand(2, 6, 9, 5, seed=4)
    n = n_displacements(d, stride)
    g = t32(_rand(2, 6, 9, n * n, seed=5))

    def grads(fn):
        leaves = [t32(a).requires_grad_(True) for a in (f1, f2)]
        return torch.autograd.grad(fn(*leaves, d, stride), leaves, g)

    for a, b in zip(grads(lambda *a: correlation(*a)),
                    grads(correlation_fwd_plain)):
        assert max_abs(a, b) <= TOL


def test_correlation_at_the_flying_chairs_feature_shape():
    """(2, 48, 64, 256) with d = 20: nearly every window overlaps the map.
    The JAX package runs its backward kernels here too; the XLA formula and
    its autograd are the reference on the CPU."""
    from ode_rl_tpu.ops.correlation import correlation as jax_corr

    f1 = _rand(2, 48, 64, 256, seed=6)
    f2 = _rand(2, 48, 64, 256, seed=7)
    _parity(lambda a, b: jax_corr(a, b, 20, 2, impl="xla"),
            lambda a, b: correlation(a, b, 20, 2), [f1, f2])


def test_correlation_finds_a_known_shift():
    """f2 is f1 moved by (1, 2): the cost volume peaks there."""
    f1 = torch.from_numpy(_rand(1, 10, 10, 16, seed=8))
    f2 = torch.roll(f1, shifts=(1, 2), dims=(1, 2))
    out = correlation(f1, f2, 2, 1)
    inner = out[0, 3:-3, 3:-3]
    assert (inner.argmax(-1) == (1 + 2) * 5 + (2 + 2)).all()


# ----------------------------- channelnorm --------------------------------

@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("c", [2, 3])
def test_channelnorm_matches_jax(c, impl):
    from ode_rl_tpu.ops.channelnorm import channelnorm as jax_cn

    x = _rand(2, 8, 6, c, seed=c) + 2.0
    _parity(lambda a: jax_cn(a, impl=impl), channelnorm, [x])


@pytest.mark.parametrize("impl", ["xla", "interpret"])
def test_channelnorm_gradient_at_exact_zero_pixels(impl):
    """Exactly-zero pixels (MNIST backgrounds through the FlowNet2
    brightness errors) take the 0 subgradient; the others x / norm."""
    from ode_rl_tpu.ops.channelnorm import channelnorm as jax_cn

    x = _rand(1, 4, 4, 3, seed=9) + 2.0
    x[0, 0, 0] = 0.0
    x[0, 2] = 0.0
    _parity(lambda a: jax_cn(a, impl=impl), channelnorm, [x])
    leaf = t32(x).requires_grad_(True)
    channelnorm(leaf).sum().backward()
    norm = np.sqrt((x ** 2).sum(-1, keepdims=True))
    expect = np.where(norm > 0, x / np.maximum(norm, 1e-12), 0.0)
    assert np.isfinite(np32(leaf.grad)).all()
    assert max_abs(leaf.grad, expect) <= TOL
    zeros = torch.zeros(1, 4, 4, 3, requires_grad=True)
    channelnorm(zeros).sum().backward()
    assert torch.equal(zeros.grad, torch.zeros_like(zeros))


# -------------------------------- warps -----------------------------------

@pytest.mark.parametrize("c", [3, 24])
def test_resample2d_matches_jax_with_flows_past_the_border(c):
    """Image and flow gradients; the flows reach 12 pixels on an 8x10 map,
    so many samples clamp at the border. C = 3 takes JAX's one-hot path,
    C = 24 its gather."""
    from ode_rl_tpu.ops.warp import resample2d as jax_resample

    image = _rand(2, 8, 10, c, seed=10)
    flow = np.random.RandomState(11).uniform(-12, 12, (2, 8, 10, 2)).astype(
        np.float32)
    _parity(jax_resample, resample2d, [image, flow])


def test_grid_sample_matches_jax():
    """A normalized grid reaching past [-1, 1], as VidODE's warps use it."""
    from ode_rl_tpu.ops.warp import grid_sample as jax_grid_sample

    image = _rand(2, 7, 9, 4, seed=12)
    grid = np.random.RandomState(13).uniform(-1.4, 1.4, (2, 5, 6, 2)).astype(
        np.float32)
    _parity(jax_grid_sample, grid_sample, [image, grid])


# -------------------------------- resize ----------------------------------

@pytest.mark.parametrize("size", [(16, 12), (4, 3), (1, 1), (256, 192),
                                  (80, 60)])
def test_resize_matches_jax_image_resize(size):
    """Down (antialiased, x4 to x64) and up (x4, as _up4 and the EPE
    metric use it), values and input gradients."""
    x = _rand(2, 64, 48, 2, seed=14)
    _parity(lambda a: jax.image.resize(a, (2, *size, 2), "bilinear"),
            lambda a: resize_bilinear(a, *size), [x])


# -------------------------------- losses ----------------------------------

def _pyramid(seed=15):
    return [_rand(2, 64 // s, 64 // s, 2, seed=seed + i)
            for i, s in enumerate((4, 8, 16, 32, 64))]


@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_multiscale_loss_matches_jax(norm):
    from ode_rl_tpu.flow.losses import multiscale_loss as jax_loss

    target = _rand(2, 64, 64, 2, seed=20, scale=3.0)
    pyramid = _pyramid()
    j = jax_loss([jnp.asarray(f) for f in pyramid], jnp.asarray(target),
                 norm=norm)
    leaves = [t32(f).requires_grad_(True) for f in pyramid]
    ours = losses.multiscale_loss(leaves, t32(target), norm=norm)
    assert abs(ours.item() - float(j)) <= TOL * abs(float(j))
    j_grads = jax.grad(lambda fs: jax_loss(fs, jnp.asarray(target),
                                           norm=norm))(
        [jnp.asarray(f) for f in pyramid])
    ours.backward()
    for leaf, g in zip(leaves, j_grads):
        assert max_abs(leaf.grad, g) <= 1e-7


def test_multiscale_loss_reference_matches_jax():
    from ode_rl_tpu.flow.losses import multiscale_loss_reference as jax_ref

    target = _rand(2, 64, 64, 2, seed=21, scale=3.0)
    pyramid = _pyramid(seed=22)
    j_loss, j_epe = jax_ref([jnp.asarray(f) for f in pyramid],
                            jnp.asarray(target))
    loss, err = losses.multiscale_loss_reference([t32(f) for f in pyramid],
                                                 t32(target))
    assert abs(float(loss) - float(j_loss)) <= TOL * abs(float(j_loss))
    assert abs(float(err) - float(j_epe)) <= TOL * abs(float(j_epe))


@pytest.mark.parametrize("name", ["epe", "l1_loss", "l2_loss"])
def test_flow_losses_match_jax_and_promote_bf16_to_fp32(name):
    """A bf16 prediction against an fp32 target is compared in fp32, as
    JAX promotes it."""
    from ode_rl_tpu.flow import losses as jax_losses

    pred = _rand(2, 8, 8, 2, seed=23)
    target = _rand(2, 8, 8, 2, seed=24)
    ours = getattr(losses, name)(t32(pred).bfloat16(), t32(target))
    j = getattr(jax_losses, name)(jnp.asarray(pred, jnp.bfloat16),
                                  jnp.asarray(target))
    assert ours.dtype == torch.float32 and j.dtype == jnp.float32
    assert abs(float(ours) - float(j)) <= TOL


# ------------------------------- dispatch ---------------------------------

def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    common.reset_launches()
    f = torch.from_numpy(_rand(1, 4, 5, 3, seed=25)).requires_grad_(True)
    out = correlation(f, f * 2, 1, 1)
    (out.sum() + channelnorm(f).sum()).backward()
    assert out.shape == (1, 4, 5, 9)
    assert all(n == 0 for n in common.launches.values())


@pytest.mark.parametrize("call", ["pair_shapes", "not_nhwc", "cotangent",
                                  "geometry", "channelnorm_rank"])
def test_flow_op_shape_mismatches_raise(call):
    x = torch.zeros(1, 4, 5, 3)
    calls = {
        "pair_shapes": lambda: correlation(x, torch.zeros(1, 4, 4, 3), 1, 1),
        "not_nhwc": lambda: correlation(x[0], x[0], 1, 1),
        "cotangent": lambda: correlation_bwd_f1(torch.zeros(1, 4, 5, 8), x,
                                                1, 1),
        "geometry": lambda: correlation(x, x, 2, 0),
        "channelnorm_rank": lambda: channelnorm(x[0]),
    }
    with pytest.raises(ValueError):
        calls[call]()
