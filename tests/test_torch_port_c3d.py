"""The modules of the S2VAE family, ConvLSTM and the Sprites DS-VAE in the
port against their flax counterparts, one by one, and the converter's
rules for their trees.

Each module: the same seeded numpy inputs and JAX's init converted by
``convert.py`` with the port's module (its submodule types decide each
kernel's layout; ``strict=True``); in fp32 the outputs to 1e-5 max abs
(1e-4 for the conv stacks, whose outputs are sums of thousands of
products) and the BatchNorm buffers to 1e-5 relative L2; then every
gradient leaf of sum(outputs * w) for random w in fp64 on both sides
(flax's module cloned with fp64 compute and parameters), to 1e-6 of the
leaf's norm plus 1e-9 of the whole gradient's norm: in fp32 the
gradients through a training-mode BatchNorm lie up to 4.4e-3 from fp64
on JAX's own side (tests/test_torch_port_s3vae.py).

Covered: ``Conv3d`` and ``C3DEncoder`` (both plans, with and without
``instance_norm``), ``SlotCNNDecoder`` (the three variants, masked and
unmasked, BatchNorm in training and eval), ``GroupNorm``, ``LSTMCell``
and the bidirectional ``LSTM`` (flax's ``OptimizedLSTMCell`` and
``sprite/dsvae.py::_LSTM``), the DCGAN encoder and decoder, and
``flax_to_torch`` on rank-5 kernels, the new transposed convs and
per-slot stacks.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import max_abs, rel_l2, t32
from test_torch_port_s3vae import (assert_grads_match, port_f64)
from ode_rl_torch.convert import flax_to_torch
from ode_rl_torch.nn.c3d import C3DEncoder, Conv3d, SlotCNNDecoder
from ode_rl_torch.nn.dense import LSTM, LSTMCell
from ode_rl_torch.nn.norm import GroupNorm
from ode_rl_torch.sprite.nets import DCGANDecoder, DCGANEncoder

RNGS = {"params": jax.random.key(0), "sample": jax.random.key(1),
        "dropout": jax.random.key(2)}


def _gen():
    return torch.Generator().manual_seed(0)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def load_port(port, variables) -> None:
    """JAX's variables into ``port``, converted by its submodule types."""
    tree = jax.tree_util.tree_map(np.asarray, dict(variables))
    port.load_state_dict(flax_to_torch(tree["params"],
                                       tree.get("batch_stats"), module=port),
                         strict=True)


def grads_as_port(grads, port) -> dict:
    return flax_to_torch(jax.tree_util.tree_map(np.asarray, grads),
                         module=port)


def module_parity(flax_mod, port_mod, inputs, port_call, *, call_kw=None,
                  out_tol=1e-5, rtol=1e-6):
    """Outputs and the BatchNorm buffers after the call in fp32, then the
    gradients of sum(outputs * w) in fp64 on both sides."""
    call_kw = call_kw or {}
    j_in = [jnp.asarray(a) for a in inputs]

    def apply(module, p, st, xs):
        out = module.apply({"params": p, **st}, *xs, **call_kw,
                           mutable=list(st) or False)
        out, new_state = out if st else (out, {})
        return jax.tree_util.tree_leaves(out), new_state

    def init_apply(xs):
        v = flax_mod.init(RNGS, *xs, **call_kw)
        st = {k: x for k, x in v.items() if k != "params"}
        return v, *apply(flax_mod, v["params"], st, xs)

    variables, j_outs, j_state = jax.jit(init_apply)(j_in)
    variables = dict(variables)
    load_port(port_mod, variables)
    state = {k: v for k, v in variables.items() if k != "params"}
    t_outs = jax.tree_util.tree_leaves(
        port_call(port_mod, *[t32(a) for a in inputs]))
    assert [tuple(o.shape) for o in t_outs] == [o.shape for o in j_outs]
    for a, b in zip(t_outs, j_outs):
        assert max_abs(a, b) <= out_tol
    if "batch_stats" in j_state:
        ref = flax_to_torch({}, jax.tree_util.tree_map(
            np.asarray, j_state["batch_stats"]), module=port_mod)
        ours = dict(port_mod.named_buffers())
        assert set(ref) == set(ours)
        for name in ref:
            assert rel_l2(ours[name], ref[name]) <= 1e-5, name

    rng = np.random.RandomState(7)
    weights = [rng.randn(*o.shape) for o in j_outs]
    with jax.enable_x64(True):
        cast = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        flax64 = flax_mod.clone(dtype=jnp.float64, param_dtype=jnp.float64)
        xs64 = [cast(a) for a in j_in]
        loss64 = lambda p: sum(jnp.sum(o * w) for o, w in zip(
            apply(flax64, p, cast(state), xs64)[0], weights))
        j_grads = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            jax.jit(jax.grad(loss64))(cast(variables["params"])))
    port64 = port_f64(port_mod)
    load_port(port64, variables)
    port64.double()
    outs64 = jax.tree_util.tree_leaves(
        port_call(port64, *[t32(a).double() for a in inputs]))
    sum(torch.sum(o * torch.from_numpy(w))
        for o, w in zip(outs64, weights)).backward()
    assert_grads_match(port64, grads_as_port(j_grads, port64), rtol=rtol,
                       atol=1e-9)
    return t_outs


# ------------------------------- C3D --------------------------------------

@pytest.mark.parametrize("mode,instance_norm,shape", [
    ("default", False, (2, 12, 32, 32, 4)),
    ("default", True, (2, 20, 32, 32, 4)),
    ("cgru", False, (2, 20, 16, 16, 4)),
    ("cgru", True, (2, 20, 16, 16, 4))])
def test_c3d_encoder_matches_flax(mode, instance_norm, shape):
    """Both plans' padding and strides in time (the 'cgru' plan pads time
    by 1 where it strides it by 2), and the biased-variance instance
    norm."""
    from ode_rl_tpu.nn.c3d import C3DEncoder as JaxC3D

    port = C3DEncoder(shape[-1], 8, mode, instance_norm, generator=_gen())
    outs = module_parity(JaxC3D(out_channels=8, mode=mode,
                                instance_norm=instance_norm), port,
                         [0.5 * _rand(*shape)], lambda m, x: m(x),
                         out_tol=1e-4)
    expect = (2, shape[1] - 10, 1, 1, 8) if mode == "default" else (
        2, 1, 2, 2, 8)
    assert tuple(outs[0].shape) == expect


def test_conv3d_stem_matches_flax():
    """S2VAE's stem: 3x3x3, stride (1, 2, 2), padding 1 on every axis."""
    class Stem(fnn.Module):
        dtype: jnp.dtype = jnp.float32
        param_dtype: jnp.dtype = jnp.float32

        @fnn.compact
        def __call__(self, x):
            return fnn.Conv(32, (3, 3, 3), strides=(1, 2, 2),
                            padding=[(1, 1), (1, 1), (1, 1)],
                            dtype=self.dtype, param_dtype=self.param_dtype,
                            name="c3d_stem")(x)

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.c3d_stem = Conv3d(2, 32, (3, 3, 3), (1, 2, 2), (1, 1, 1),
                                   generator=_gen())

    port = Port()
    module_parity(Stem(), port, [_rand(2, 4, 8, 8, 2)],
                  lambda m, x: m.c3d_stem(x))
    assert port.c3d_stem.weight.shape == (32, 2, 3, 3, 3)


# ---------------------------- slot decoder ---------------------------------

@pytest.mark.parametrize("variant,unmasked,train", [
    ("s2vae", True, True), ("s2vae", False, False),
    ("cs2vae", True, False), ("cs2vae", False, True),
    ("ds2vae", True, True), ("ds2vae", False, False)])
def test_slot_cnn_decoder_matches_flax(variant, unmasked, train):
    """'s2vae' from 1x1 by the 4x4 VALID transposed conv, the others from
    4x4 by the 3x3 SAME one; the alpha channel where masked; BatchNorm on
    the batch (moving its buffers) or on the running statistics."""
    from ode_rl_tpu.nn.c3d import SlotCNNDecoder as JaxDec

    hw = 1 if variant == "s2vae" else 4
    port = SlotCNNDecoder(6, 1, variant, unmasked, generator=_gen())
    outs = module_parity(
        JaxDec(out_channels=1, variant=variant, unmasked=unmasked), port,
        [_rand(3, hw, hw, 6)], lambda m, x: m(x, train),
        call_kw={"train": train}, out_tol=1e-4)
    assert tuple(outs[0].shape) == (3, 64, 64, 1 if unmasked else 2)


# ------------------------------ GroupNorm ----------------------------------

@pytest.mark.parametrize("shape,groups", [((2, 4, 4, 64), 2),
                                           ((3, 5, 96), 3)])
def test_group_norm_matches_flax(shape, groups):
    """flax's eps 1e-6 and contiguous groups on the last axis."""
    class Norm(fnn.Module):
        dtype: jnp.dtype = jnp.float32
        param_dtype: jnp.dtype = jnp.float32

        @fnn.compact
        def __call__(self, x):
            return fnn.GroupNorm(num_groups=groups, dtype=self.dtype,
                                 param_dtype=self.param_dtype,
                                 name="norm")(x)

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.norm = GroupNorm(shape[-1], groups)

    module_parity(Norm(), Port(), [0.5 + _rand(*shape)],
                  lambda m, v: m.norm(v))
    # Against the formula with the other eps, it differs.
    v = t32(0.001 * _rand(*shape))
    assert max_abs(Port().norm(v), torch.nn.functional.group_norm(
        v.movedim(-1, 1), groups, eps=1e-5).movedim(1, -1)) > 1e-4


# -------------------------------- LSTM -------------------------------------

def test_lstm_cell_matches_flax():
    """flax's OptimizedLSTMCell: gates i, f, g, o, no forget bias, input
    Denses without bias, carry (c, h)."""
    class Cell(fnn.Module):
        dtype: jnp.dtype = jnp.float32
        param_dtype: jnp.dtype = jnp.float32

        @fnn.compact
        def __call__(self, c, h, x):
            return fnn.OptimizedLSTMCell(
                features=12, dtype=self.dtype, param_dtype=self.param_dtype,
                name="cell")((c, h), x)

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.cell = LSTMCell(5, 12, generator=_gen())

    port = Port()
    module_parity(Cell(), port, [_rand(3, 12, seed=1), _rand(3, 12, seed=2),
                                 _rand(3, 5, seed=3)],
                  lambda m, c, h, x: m.cell((c, h), x))
    names = {n for n, _ in port.named_parameters()}
    assert "cell.if.kernel" in names and "cell.if.bias" not in names
    assert "cell.hf.bias" in names


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_matches_jax(reverse):
    """The hoisted LSTM of sprite/dsvae.py, forward and backward in time
    (outputs at their inputs' positions)."""
    from ode_rl_tpu.sprite.dsvae import _LSTM

    port = LSTM(6, 10, reverse=reverse, generator=_gen())
    module_parity(_LSTM(10, reverse=reverse), port, [_rand(2, 5, 6)],
                  lambda m, x: m(x))


# -------------------------------- DCGAN ------------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_dcgan_nets_match_flax(train):
    """At nf 8: the encoder's 4x4 convs and BatchNorms to a g_dim vector,
    the decoder's d1 (VALID from 1x1) and d2-d5 ('SAME', stride 2)."""
    from ode_rl_tpu.sprite.nets import DCGANDecoder as JaxDec
    from ode_rl_tpu.sprite.nets import DCGANEncoder as JaxEnc

    enc = DCGANEncoder(3, 16, nf=8, generator=_gen())
    module_parity(JaxEnc(g_dim=16, nf=8), enc,
                  [np.random.RandomState(0).rand(3, 64, 64, 3)
                   .astype(np.float32)],
                  lambda m, x: m(x, train), call_kw={"train": train},
                  out_tol=1e-4)
    dec = DCGANDecoder(12, 3, nf=8, generator=_gen())
    outs = module_parity(JaxDec(out_channels=3, nf=8), dec,
                         [_rand(3, 12)], lambda m, z: m(z, train),
                         call_kw={"train": train}, out_tol=1e-4)
    assert tuple(outs[0].shape) == (3, 64, 64, 3)
    assert dec.d1.weight.shape == (12, 64, 4, 4)


# ------------------------------ converter ----------------------------------

def test_converter_layouts_by_module_type():
    """A rank-5 kernel becomes (O, I, kd, kh, kw); a transposed conv whose
    name no rule knows (``d3``, ``up``, ``head_deconv``) is flipped by its
    type; per-slot stacks split in order, a rank-5 leaf there being a
    stack of 2-D kernels; without the module the name rules hold as
    before."""
    from ode_rl_torch.models.convlstm import ConvLSTMED
    from ode_rl_torch.models.s2vae import S2VAEModel

    rng = np.random.RandomState(0)
    k5 = rng.randn(3, 4, 4, 2, 5).astype(np.float32)
    conv = Conv3d(2, 5, (3, 4, 4), (1, 2, 2), (0, 1, 1), generator=_gen())
    holder = torch.nn.Module()
    holder.conv = conv
    out = flax_to_torch({"conv": {"kernel": k5, "bias": np.zeros(5)}},
                        module=holder)
    assert np.array_equal(out["conv.weight"].numpy(),
                          k5.transpose(4, 3, 0, 1, 2))
    # Without the module a rank-5 leaf copies by name, as before.
    assert "conv.kernel" in flax_to_torch({"conv": {"kernel": k5}})

    model = ConvLSTMED(1, (((4, 3, 2), 8),), (), generator=_gen())
    kd = rng.randn(4, 4, 8, 64).astype(np.float32)
    out = flax_to_torch({"head_deconv": {"kernel": kd}}, module=model)
    assert np.array_equal(out["head_deconv.weight"].numpy(),
                          np.flip(kd, (0, 1)).transpose(2, 3, 0, 1))
    # By name alone head_deconv would be taken for a plain conv.
    assert flax_to_torch({"head_deconv": {"kernel": kd}})[
        "head_deconv.weight"].shape == (64, 8, 4, 4)

    s2 = S2VAEModel(1, 8, num_slots=3, slot_size=4, transition="cgru",
                    conv_mode=True, generator=_gen())
    up = rng.randn(3, 4, 4, 4, 4).astype(np.float32)
    gates = rng.randn(3, 5, 5, 8, 8).astype(np.float32)
    scale = rng.randn(3, 8).astype(np.float32)
    out = flax_to_torch({"slot_rollout": {
        "up": {"kernel": up},
        "trans": {"conv_gates": {"kernel": gates}, "gates_scale": scale}}},
        module=s2)
    for s in range(3):
        assert np.array_equal(out[f"slot_rollout.{s}.up.weight"].numpy(),
                              np.flip(up[s], (0, 1)).transpose(2, 3, 0, 1))
        assert np.array_equal(
            out[f"slot_rollout.{s}.trans.conv_gates.weight"].numpy(),
            gates[s].transpose(3, 2, 0, 1))
        assert np.array_equal(
            out[f"slot_rollout.{s}.trans.gates_scale"].numpy(), scale[s])
