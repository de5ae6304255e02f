"""The stacked FlowNets of the PyTorch port against flax: FlowNetCS at full
width (FlowNetC at d = 20 -> resample2d -> channelnorm -> FlowNetS, so it
runs the plain versions of all four kernels K5-K8 and the warp), the
parameter count of FlowNet2, FlowNet2's input normalisation and fusion
input with its sub-nets stubbed, and the whole FlowNet2 stack (slow tier,
as the JAX package's own FlowNet2 test).

Tolerances as in test_torch_port_flow_nets.py: outputs 1e-5 relative L2,
parameter gradients 1e-4 relative L2; the normalised images, which lie in
[-1, 1], 1e-6 max abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_flax, max_abs, net_parity, rel_l2, t32
from ode_rl_torch.flow import flownets
from ode_rl_torch.ops import common


def _pair(seed):
    rng = np.random.RandomState(seed)
    return [rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
            for _ in range(2)]


def test_flownetcs_matches_flax():
    from ode_rl_tpu.flow.flownets import FlowNetCS

    common.reset_launches()
    net_parity(FlowNetCS(),
               flownets.FlowNetCS(generator=torch.Generator().manual_seed(0)),
               _pair(1))
    assert all(n == 0 for n in common.launches.values())


def test_flownet2_parameter_count():
    """162,518,834 parameters, as the reference pins (counted on the meta
    device, so nothing is allocated)."""
    with torch.device("meta"):
        model = flownets.FlowNet2(generator=torch.Generator())
    assert sum(p.numel() for p in model.parameters()) == 162_518_834


def _pool4(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 4, 4, w // 4, 4, c).mean((2, 4))


# Stand-ins for FlowNet2's three sub-nets, the same formulas on both sides:
# the two branches return a flow at 1/4 resolution (up to a few pixels once
# upsampled, so some warps cross the border), the fusion net returns its
# input.
_STAND_INS = {
    "css": lambda img1n, img2n: [8.0 * _pool4(img1n - img2n)[..., :2]],
    "flownetsd": lambda x: [8.0 * _pool4(x)[..., 3:5]],
    "fusion": lambda x: x,
}


class _StandIn(torch.nn.Module):
    def __init__(self, name, seen):
        super().__init__()
        self.name, self.seen = name, seen

    def forward(self, *args):
        self.seen[self.name] = args
        return _STAND_INS[self.name](*args)


def test_flownet2_normalisation_and_fusion_input_match_flax():
    """FlowNet2's own code with its sub-nets stubbed: the images divided by
    rgb_max and centred by the per-sample channel mean over (pair, H, W), as
    the sub-nets receive them, and the fusion input (upsampled flows, warps,
    channelnorms, in the flax concat order). B = 2 with different
    brightness per sample, so a mean over the batch would show."""
    from flax import linen as nn
    from ode_rl_tpu.flow.flownets import FlowNet2

    rng = np.random.RandomState(4)
    imgs = [(rng.uniform(0, 255, (2, 64, 64, 3))
             * np.array([1.0, 0.5]).reshape(2, 1, 1, 1)).astype(np.float32)
            for _ in range(2)]
    j_seen = {}

    def interceptor(next_fun, args, kwargs, context):
        name = context.module.name
        if context.method_name != "__call__" or name not in _STAND_INS:
            return next_fun(*args, **kwargs)
        j_seen[name] = args
        return _STAND_INS[name](*args)

    with nn.intercept_methods(interceptor):
        j_out = FlowNet2(rgb_max=255.0).apply(
            {}, *[jnp.asarray(a) for a in imgs])

    t_seen = {}
    with torch.device("meta"):
        model = flownets.FlowNet2(255.0, generator=torch.Generator())
    for name in _STAND_INS:
        setattr(model, name, _StandIn(name, t_seen))
    t_out = model(*[t32(a) for a in imgs])

    assert set(t_seen) == set(j_seen) == set(_STAND_INS)
    for name in ("css", "flownetsd"):
        for a, b in zip(t_seen[name], j_seen[name], strict=True):
            assert max_abs(a, b) <= 1e-6, name
    assert t_out.shape == j_out.shape == (2, 64, 64, 3 + 2 + 2 + 1 + 1 + 1 + 1)
    assert rel_l2(t_out, j_out) <= 1e-5


@pytest.mark.slow
def test_flownet2_forward_and_step_match_flax():
    """The whole stack at 162M parameters: output and every gradient leaf,
    then one single-scale L1 step of each side's train step."""
    from ode_rl_tpu.flow.flownets import FlowNet2
    from ode_rl_tpu.flow.train import make_flow_train_step as jax_step
    from ode_rl_torch.flow.train import make_flow_train_step

    img1, img2 = _pair(2)
    target = np.random.RandomState(3).randn(1, 64, 64, 2).astype(np.float32)
    net_parity(FlowNet2(),
               flownets.FlowNet2(generator=torch.Generator().manual_seed(0)),
               [img1, img2])

    init_fn, step_fn = jax_step(FlowNet2(), single_scale=True)
    state = init_fn(jax.random.key(0), (jnp.asarray(img1), jnp.asarray(img2)))
    _, j_metrics = step_fn(state, (jnp.asarray(img1), jnp.asarray(img2)),
                           jnp.asarray(target))
    model = flownets.FlowNet2(generator=torch.Generator().manual_seed(0))
    load_flax(model, state["params"]["params"])
    t_init, t_step = make_flow_train_step(model, single_scale=True)
    metrics = t_step(t_init(), (t32(img1), t32(img2)), t32(target))
    for key in ("loss", "epe"):
        assert rel_l2(metrics[key], j_metrics[key]) <= 1e-5, key
