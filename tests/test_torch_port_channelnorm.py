"""K8 (channelnorm) on the CPU: the plain version and ChannelNormFn.

The kernel (``csrc/channelnorm.cu``) cannot run here, so what it rests on
is tested instead:

* the plain version, which the wrapper takes for CPU tensors and which
  sums the squares in channel order as the kernel does, against the JAX
  Pallas kernel (``_channelnorm_pallas``) in interpret mode at FlowNet2's
  channel counts and a few others, exact-zero pixels included: 1e-6 max
  abs in fp32 (fp32 sums of a few squares, whose order may differ), one
  bf16 ulp in bf16;
* the hand-written backward of ``ChannelNormFn`` against the JAX
  ``custom_vjp`` (``_cn_op("interpret")``), 0 at the zero pixels, and on
  the same norm as the forward, bit for bit, and on a strided view.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import max_abs, t32
from ode_rl_torch.ops.channelnorm import (ChannelNormFn, channelnorm,
                                          channelnorm_fwd, channelnorm_plain)

TOL = 1e-6
CHANNELS = [1, 2, 3, 4, 8]


def _frames(c, seed):
    """(2, 8, 8, C) fp32 with exact-zero pixels, as FlowNet2's brightness
    errors have on MNIST's black background."""
    x = np.random.RandomState(seed).randn(2, 8, 8, c).astype(np.float32)
    x[0, :3] = 0.0
    x[1, 5, 2:6] = 0.0
    return x


@pytest.mark.parametrize("c", CHANNELS)
def test_plain_channelnorm_matches_the_pallas_kernel(c):
    from ode_rl_tpu.ops.channelnorm import _channelnorm_pallas

    x = _frames(c, seed=c)
    ref = _channelnorm_pallas(jnp.asarray(x), interpret=True)
    out = channelnorm_fwd(t32(x))
    assert out.shape == ref.shape == (2, 8, 8, 1)
    assert max_abs(out, ref) <= TOL
    assert (out[0, :3] == 0).all() and (out[1, 5, 2:6] == 0).all()


@pytest.mark.parametrize("c", [2, 3])
def test_plain_channelnorm_matches_the_pallas_kernel_in_bf16(c):
    """bf16 in, bf16 out: both reduce in fp32 and round once, so they are
    within one bf16 ulp (2^-8 of the value) of each other."""
    from ode_rl_tpu.ops.channelnorm import _channelnorm_pallas

    x = t32(_frames(c, seed=40 + c)).bfloat16()
    ref = _channelnorm_pallas(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                              interpret=True)
    out = channelnorm_fwd(x)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 8, 8, 1)
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    assert ((out.float() - ref).abs() <= ref.abs() * 2.0 ** -8).all()
    assert (out[0, :3] == 0).all()


@pytest.mark.parametrize("c", CHANNELS)
def test_plain_channelnorm_adds_channels_in_order(c):
    """The plain version is the sequential fp32 sum the kernel computes,
    bit for bit, in fp32 and from bf16 inputs."""
    x = t32(_frames(c, seed=10 + c)) * 1e3
    for xt in (x, x.bfloat16()):
        xf = xt.float()
        total = xf[..., 0] * xf[..., 0]
        for k in range(1, c):
            total = total + xf[..., k] * xf[..., k]
        assert torch.equal(channelnorm_plain(xt),
                           torch.sqrt(total)[..., None].to(xt.dtype))


@pytest.mark.parametrize("c", CHANNELS[:4])
def test_channelnorm_gradient_matches_the_jax_custom_vjp(c):
    from ode_rl_tpu.ops.channelnorm import _cn_op

    x = _frames(c, seed=20 + c)
    g = np.random.RandomState(30 + c).randn(2, 8, 8, 1).astype(np.float32)
    _, vjp = jax.vjp(_cn_op("interpret"), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    leaf = t32(x).requires_grad_(True)
    (gx,) = torch.autograd.grad(ChannelNormFn.apply(leaf), leaf, t32(g))
    assert max_abs(gx, ref) <= TOL
    assert (gx[0, :3] == 0).all()


@pytest.mark.parametrize("c", CHANNELS[:4])
def test_channelnorm_backward_divides_by_the_forward_norm(c):
    """The backward recomputes the norm with the forward's ordered sum: in
    fp32 its x * g / norm is bit-equal to the same expression on the
    forward's output."""
    x = t32(_frames(c, seed=50 + c)) * 1e3
    g = t32(np.random.RandomState(60 + c).randn(2, 8, 8, 1))
    leaf = x.clone().requires_grad_(True)
    out = ChannelNormFn.apply(leaf)
    (gx,) = torch.autograd.grad(out, leaf, g)
    assert torch.equal(gx, x * (g / torch.clamp_min(out.detach(), 1e-12)))


def test_channelnorm_takes_a_strided_view():
    """channelnorm makes its input contiguous: an NCHW tensor permuted to
    NHWC gives the norm of its contiguous copy."""
    x = t32(_frames(3, seed=70)).permute(0, 3, 1, 2).contiguous()
    view = x.permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    assert torch.equal(channelnorm(view),
                       channelnorm_plain(view.contiguous()))
