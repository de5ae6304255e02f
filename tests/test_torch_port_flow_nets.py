"""The FlowNet networks of the PyTorch port against their flax
counterparts, with flax's weights converted by ``ode_rl_torch.convert``:
the transposed-conv layers, FlowNetS, FlowNetSD, FlowNetFusion and
FlowNetC (correlation through the K5-K7 plain versions), at B=1, 64x64,
fp32, full width; and the converter on the FlowNetC and FlowNet2 trees.

Tolerances: outputs 1e-5 relative L2 (max abs 2e-5 for single layers);
every parameter gradient 1e-4 relative L2 (a leaf sums over thousands of
products, and the nets are ten layers deep).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import max_abs, net_parity
from ode_rl_torch.convert import flax_to_torch
from ode_rl_torch.flow import flownets

def _gen():
    return torch.Generator().manual_seed(0)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("use_bias", [True, False])
def test_upflow_matches_flax(use_bias):
    """flax's 'SAME' ConvTranspose is torch's with the kernel flipped."""
    from ode_rl_tpu.flow.flownets import _UpFlow

    net_parity(_UpFlow(use_bias=use_bias),
               flownets._UpFlow(use_bias, dtype=torch.float32,
                                generator=_gen()),
               [_rand(1, 5, 6, 2, seed=1)], max_abs, 2e-5)


def test_deconv_matches_flax():
    from ode_rl_tpu.flow.flownets import _Deconv

    net_parity(_Deconv(8), flownets._Deconv(4, 8, dtype=torch.float32,
                                            generator=_gen()),
               [_rand(1, 5, 6, 4, seed=2) - 0.5], max_abs, 2e-5)


def test_flownets_matches_flax():
    from ode_rl_tpu.flow.flownets import FlowNetS

    net_parity(FlowNetS(), flownets.FlowNetS(generator=_gen()),
               [_rand(1, 64, 64, 6, seed=3)])


def test_flownetsd_matches_flax():
    from ode_rl_tpu.flow.flownets import FlowNetSD

    net_parity(FlowNetSD(), flownets.FlowNetSD(generator=_gen()),
               [_rand(1, 64, 64, 6, seed=4)])


def test_flownet_fusion_matches_flax():
    from ode_rl_tpu.flow.flownets import FlowNetFusion

    net_parity(FlowNetFusion(), flownets.FlowNetFusion(generator=_gen()),
               [_rand(1, 64, 64, 11, seed=5)])


def test_flownetc_matches_flax():
    """Shared conv tower on both images, correlation at d = 4, stride 2,
    the redirect conv and the biased up-flows."""
    from ode_rl_tpu.flow.flownets import FlowNetC

    net_parity(FlowNetC(max_displacement=4, corr_stride=2),
               flownets.FlowNetC(4, 2, generator=_gen()),
               [_rand(1, 64, 64, 3, seed=6), _rand(1, 64, 64, 3, seed=7)])


@pytest.mark.parametrize("slope", [0.1, 0.2])
def test_leaky_relu_gradient_at_zero_matches_jax(slope):
    """Exact zeros reach the activations (a zero bias on a zero background):
    JAX's gradient there is 1, not the slope."""
    from ode_rl_torch.nn.conv_stacks import leaky_relu

    x = np.array([-1.5, -0.0, 0.0, 2.0], np.float32)
    j = jax.grad(lambda a: jnp.sum(jax.nn.leaky_relu(a, slope) * 3.0))(
        jnp.asarray(x))
    leaf = torch.from_numpy(x).requires_grad_(True)
    (leaky_relu(leaf, slope) * 3.0).sum().backward()
    assert max_abs(leaf.grad, j) == 0.0


def _zero_tree(flax_module, *shapes):
    """A numpy tree of zeros with the structure and shapes of
    ``flax_module.init``, without running the init."""
    abstract = jax.eval_shape(
        flax_module.init, jax.random.key(0),
        *[jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes])["params"]
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                  abstract)


@pytest.mark.parametrize("name,n_leaves", [("FlowNetC", 48),
                                           ("FlowNet2", 220)])
def test_converted_flax_trees_load_strictly(name, n_leaves):
    """Every leaf of the flax tree maps to one parameter of the port with
    its shape, and none is left over (``strict=True``)."""
    import ode_rl_tpu.flow.flownets as jax_flownets

    tree = _zero_tree(getattr(jax_flownets, name)(), (1, 64, 64, 3),
                      (1, 64, 64, 3))
    leaves = jax.tree_util.tree_leaves(tree)
    state = flax_to_torch(tree)
    with torch.device("meta"):
        port = getattr(flownets, name)(generator=torch.Generator())
    port.load_state_dict(state, strict=True, assign=True)
    assert len(leaves) == len(state) == len(port.state_dict()) == n_leaves
    assert sum(int(np.prod(a.shape)) for a in leaves) == sum(
        p.numel() for p in port.parameters())
