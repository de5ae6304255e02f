"""The Moving MNIST recurrent family in the port against the JAX package:
the ConvGRU scan functions, ``ConvGRUModel`` with and without ``decODE``,
``odeint_memory`` (nru, nru2) and the ODEConv model with each, the
sampled z0 with its KL term, and the recipe's model with the z0
encoder's ``hoist_projections`` on. Every model is built by both registries from
one config (``configs.yaml`` blocks narrowed to 32 channels, batch 2,
16x16 frames, 4 -> 4 frames), and the port is loaded with JAX's init
(``convert.py``) with ``strict=True``.

Tolerances, as tests/test_torch_port_recipe.py: outputs and predictions
to 1e-4 max abs, losses to 1e-5 relative, every gradient leaf to 1e-3
relative L2, solver stats equal. The port's fused and unfused ConvGRU
paths to 1e-5 max abs of each other, as tests/test_fast_rnn.py holds
JAX's.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from torch_port_util import (assert_grads_close, load_flax, max_abs,
                             rel_l2, t32)
from ode_rl_torch.core.config import load_config
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.models.registry import build_model
from ode_rl_torch.nn.convgru import (ConvGRUCell, convgru_freerun,
                                     convgru_scan)
from ode_rl_torch.ode.memory import odeint_memory
from ode_rl_torch.train.step import loss_and_grads

C, B, S, T_IN, T_OUT = 32, 2, 16, 4, 4
NARROW = dict(conv_encoder_out_ch=C, convgru_out_ch=C, latent_dim=C,
              neural_ode_decoder_out_ch=C, neural_ode_n_units=C,
              batch_size=B, train_in_seq=T_IN, train_out_seq=T_OUT)
OUT_TOL, LOSS_TOL, GRAD_TOL, FUSED_TOL = 1e-4, 1e-5, 1e-3, 1e-5


def _video(seed=0, b=B, t=T_IN + T_OUT):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, t, S, S, 1) - 0.5).astype(np.float32)


def _gen():
    return torch.Generator().manual_seed(0)


# ----------------------------- scan functions ------------------------------

class _FlaxScan(fnn.Module):
    hidden: int
    mode: str            # "scan" or "freerun"
    fused: bool
    reverse: bool = False

    @fnn.compact
    def __call__(self, h0, xs=None, mask=None):
        from ode_rl_tpu.nn.convgru import (ConvGRUCell as FlaxCell,
                                           convgru_freerun as jfree,
                                           convgru_scan as jscan)
        cell = FlaxCell(hidden_dim=self.hidden, name="cell")
        if self.mode == "scan":
            return jscan(cell, h0, xs, mask=mask, reverse=self.reverse,
                         fused=self.fused)
        return jfree(cell, h0, T_OUT + 1, fused=self.fused)


class _PortScan(nn.Module):
    def __init__(self, x_ch, hidden, mode, fused, reverse=False):
        super().__init__()
        self.cell = ConvGRUCell(x_ch, hidden, generator=_gen())
        self.mode, self.fused, self.reverse = mode, fused, reverse

    def forward(self, h0, xs=None, mask=None):
        if self.mode == "scan":
            return convgru_scan(self.cell, h0, xs, mask=mask,
                                reverse=self.reverse, fused=self.fused)
        return convgru_freerun(self.cell, h0, T_OUT + 1, fused=self.fused)


def _scan_inputs(mode, with_mask):
    rng = np.random.RandomState(1)
    h0 = rng.randn(B, 8, 8, C).astype(np.float32)
    if mode == "freerun":
        return [h0], None
    xs = rng.randn(B, 5, 8, 8, 24).astype(np.float32)
    mask = (np.array([[1, 0, 1, 1, 0], [1, 1, 0, 1, 1]], np.float32)
            if with_mask else None)
    return [h0, xs], mask


def _scan_parity(mode, fused, reverse=False, with_mask=False):
    """(hiddens, h_last) and the gradients of sum(outputs * w) for the
    parameters and inputs, flax against the port."""
    inputs, mask = _scan_inputs(mode, with_mask)
    flax_mod = _FlaxScan(C, mode, fused, reverse)
    j_in = [jnp.asarray(a) for a in inputs]
    j_mask = None if mask is None else jnp.asarray(mask)
    variables = flax_mod.init(jax.random.key(0), *j_in, mask=j_mask)
    x_ch = inputs[1].shape[-1] if mode == "scan" else C
    port = _PortScan(x_ch, C, mode, fused, reverse)
    load_flax(port, variables["params"])

    j_outs = flax_mod.apply(variables, *j_in, mask=j_mask)
    rng = np.random.RandomState(7)
    weights = [rng.randn(*o.shape).astype(np.float32) for o in j_outs]

    def loss(params, *xs):
        outs = flax_mod.apply({"params": params}, *xs, mask=j_mask)
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights))

    j_grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(j_in) + 1))))(
        variables["params"], *j_in)
    leaves = [t32(a).requires_grad_(True) for a in inputs]
    t_outs = port(*leaves, mask=None if mask is None else t32(mask))
    sum(torch.sum(o * t32(w)) for o, w in zip(t_outs, weights)).backward()
    for a, b in zip(t_outs, j_outs):
        assert a.shape == b.shape
        assert max_abs(a, b) <= OUT_TOL
    assert_grads_close(port, j_grads[0], GRAD_TOL)
    for leaf, g in zip(leaves, j_grads[1:]):
        assert rel_l2(leaf.grad, g) <= GRAD_TOL
    return port, t_outs


@pytest.mark.parametrize("fused,reverse,with_mask", [
    (True, False, False), (False, False, False), (True, True, True),
    (False, True, True)])
def test_convgru_scan_matches_jax(fused, reverse, with_mask):
    _scan_parity("scan", fused, reverse, with_mask)


@pytest.mark.parametrize("fused", [True, False])
def test_convgru_freerun_matches_jax(fused):
    port, _ = _scan_parity("freerun", fused)
    if fused:
        # The free-run cell's x-side kernel half sees only zeros: its
        # gradient is exactly zero (JAX declares the same shapes).
        w = port.cell.conv_gates.weight
        assert w.shape[1] == 2 * C
        assert torch.count_nonzero(w.grad[:, :C]) == 0
        assert torch.count_nonzero(port.cell.conv_cand.weight.grad[:, :C]) == 0


@pytest.mark.parametrize("mode", ["scan", "freerun"])
def test_convgru_fused_matches_unfused(mode):
    inputs, mask = _scan_inputs(mode, with_mask=True)
    x_ch = inputs[1].shape[-1] if mode == "scan" else C
    fused = _PortScan(x_ch, C, mode, True, reverse=True)
    unfused = _PortScan(x_ch, C, mode, False, reverse=True)
    unfused.load_state_dict(fused.state_dict())
    args = [t32(a) for a in inputs]
    m = None if mask is None else t32(mask)
    for a, b in zip(fused(*args, mask=m), unfused(*args, mask=m)):
        assert max_abs(a, b) <= FUSED_TOL


def test_free_run_cell_refuses_another_input_width():
    cell = ConvGRUCell(24, C, generator=_gen())
    with pytest.raises(ValueError, match="hidden width"):
        convgru_freerun(cell, torch.zeros(B, 8, 8, C), 2)


# ------------------------------- the models --------------------------------

def _configs(blocks, **overrides):
    from ode_rl_tpu.core.config import load_config as jax_load
    return (jax_load(blocks, overrides={**NARROW, **overrides}),
            load_config(blocks, overrides={**NARROW, **overrides}))


def _model_parity(blocks, seed=0, eps=None, monkeypatch=None, tweak=None,
                  port_setup=None, **overrides):
    """One loss and its gradients through both registries' models from
    JAX's init (passed through ``tweak`` where given; ``port_setup`` is
    applied to the port's model before it is loaded); returns the port's
    metrics and model."""
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    from ode_rl_tpu.models.registry import build_model as jax_build

    jcfg, cfg = _configs(blocks, **overrides)
    video = _video(seed)
    jb = jax_batch(jnp.asarray(video), n_in=T_IN)
    model = jax_build(jcfg)
    rngs = {"params": jax.random.key(0), "sample": jax.random.key(1)}
    params = jax.jit(lambda b: model.init(rngs, b, method=model.loss))(
        jb)["params"]
    if tweak is not None:
        params = tweak(params)
    generator = None
    if eps is not None:
        # The same noise on both sides: JAX's normal draw returns the
        # port's first draw from ``generator``.
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, dtype=jnp.float32:
                            jnp.asarray(eps, dtype).reshape(shape))
        generator = torch.Generator().manual_seed(11)

    def loss_fn(p):
        return model.apply({"params": p}, jb, method=model.loss,
                           rngs={"sample": jax.random.key(2)})

    (j_loss, (j_metrics, j_pred)), j_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    port = build_model(cfg, torch.device("cpu"), _gen())
    if port_setup is not None:
        port_setup(port)
    load_flax(port, params)          # strict: every leaf converts
    metrics, pred = loss_and_grads(port, make_batch_dict(t32(video), T_IN),
                                   generator)
    assert pred.shape == j_pred.shape
    assert max_abs(pred, j_pred) <= OUT_TOL
    assert abs(float(metrics["loss"]) / float(j_loss) - 1.0) <= LOSS_TOL
    assert set(metrics) == set(j_metrics) | {"grad_norm"}
    for k, v in j_metrics.items():
        if k in ("loss", "mse", "z0_kl"):
            assert abs(float(metrics[k]) / float(v) - 1.0) <= LOSS_TOL, k
        else:
            assert metrics[k] == int(v), k
    assert_grads_close(port, j_grads, GRAD_TOL)
    return metrics, port


@pytest.mark.parametrize("dec_ode", [False, True])
def test_convgru_model_matches_jax(dec_ode):
    block = "train_mmnist_cgrudecODE" if dec_ode else "train_mmnist_cgru_len20"
    metrics, port = _model_parity(["defaults", block])
    names = {n for n, _ in port.named_parameters()}
    if dec_ode:
        assert set(metrics) >= {"nfe", "ode_converged"}
        # Field convs keep HWIO; the 1x1 projection is OIHW.
        assert "dec_ode_func.mid_0.kernel" in names
        assert port.to_z0.weight.shape == (C, C, 1, 1)
        assert not any(n.startswith("dec_gru") for n in names)
    else:
        assert set(metrics) == {"loss", "mse", "grad_norm"}
        assert port.dec_gru.conv_gates.weight.shape == (2 * C, 2 * C, 5, 5)
    assert port.dec_0.weight.shape == (C, 32, 4, 4)   # (in, out, kh, kw)
    assert port.dec_1.weight.shape == (32, 1, 4, 4)


def test_odeint_memory_matches_jax():
    """nru and nru2 on a small analytic field with parameters: the
    trajectory, the NFE, and the gradients for z0 and the parameters."""
    from ode_rl_tpu.ode.memory import odeint_memory as jax_memory

    rng = np.random.RandomState(3)
    z0 = rng.randn(2, 3, 4).astype(np.float32)
    a = (0.5 + rng.rand(4)).astype(np.float32)
    m = (0.3 * rng.randn(4, 4)).astype(np.float32)
    tp = np.array([0.5, 0.6, 0.8, 1.1], np.float32)
    w = rng.randn(4, 2, 3, 4).astype(np.float32)
    for mode in ("nru", "nru2"):
        def jloss(z, a_, m_):
            f = lambda t, y: jnp.tanh(y @ m_) - a_ * y
            ys, stats = jax_memory(f, z, jnp.float32(0.4), jnp.asarray(tp),
                                   rtol=1e-4, atol=1e-5, max_steps=64,
                                   mode=mode)
            return jnp.sum(ys * w), (ys, stats["nfe"])

        (_, (j_ys, j_nfe)), j_grads = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True))(z0, a, m)
        leaves = [t32(v).requires_grad_(True) for v in (z0, a, m)]
        f = lambda t, y: torch.tanh(y @ leaves[2]) - leaves[1] * y
        ys, stats = odeint_memory(f, leaves[0], torch.tensor(0.4),
                                  torch.from_numpy(tp), rtol=1e-4,
                                  atol=1e-5, max_steps=64, mode=mode)
        torch.sum(ys * t32(w)).backward()
        assert ys.shape == j_ys.shape and max_abs(ys, j_ys) <= OUT_TOL, mode
        assert stats == {"nfe": int(j_nfe)}, mode
        for leaf, g in zip(leaves, j_grads):
            assert rel_l2(leaf.grad, g) <= GRAD_TOL, mode
    with pytest.raises(NotImplementedError, match="nru"):
        odeint_memory(f, leaves[0], 0.4, tp, mode="nru3")


@pytest.mark.parametrize("mode", ["nru", "nru2"])
def test_memory_model_matches_jax(mode):
    metrics, port = _model_parity(
        ["defaults", "train_mmnist_odecgrumem_len20_1ch"], mem_mode=mode)
    assert port.mem and port.mem_mode == mode
    assert set(metrics) == {"loss", "mse", "nfe", "grad_norm"}


def test_hoisted_encoder_matches_jax(monkeypatch):
    """The recipe's model with the z0 encoder's observation projections
    hoisted out of the loop (``hoist_projections``) on both sides: JAX's
    registry builds the encoder with the flag set, through a stand-in for
    the class inside the test. Then the port's hoisted and unhoisted
    encoder on the same weights agree to the fused tolerance."""
    import functools
    import ode_rl_tpu.models.odeconvgru as jax_odeconvgru

    monkeypatch.setattr(jax_odeconvgru, "ODEConvGRUEncoder",
                        functools.partial(jax_odeconvgru.ODEConvGRUEncoder,
                                          hoist_projections=True))

    def hoist(port):
        port.z0_encoder.hoist_projections = True

    _, port = _model_parity(["defaults", "train_mmnist_odecgru_len20_1ch"],
                            port_setup=hoist)
    batch = make_batch_dict(t32(_video()), T_IN)
    with torch.no_grad():
        enc = port.conv_encoder(batch["observed_data"].reshape(
            B * T_IN, S, S, 1) + 0.5).reshape(B, T_IN, 4, 4, C)
        hoisted = port.z0_encoder(enc, batch["observed_tp"])
        port.z0_encoder.hoist_projections = False
        plain = port.z0_encoder(enc, batch["observed_tp"])
    for a, b in zip(hoisted, plain):
        assert max_abs(a, b) <= FUSED_TOL


def _std_bias_one(params):
    """The z0 head's std half of the bias set to 1. The KL term's gradient
    in std is 1/(std + 1e-6): at init some std lies within 1e-5 of zero,
    where it multiplies the fp32 rounding of std (which the two sides
    reassociate differently) by 1e5, on both sides alike. Training moves
    std towards 1, where the term is well conditioned; the test holds the
    port there."""
    params = jax.tree_util.tree_map(lambda a: a, params)
    bias = params["z0_encoder"]["head_1"]["bias"]
    params["z0_encoder"]["head_1"]["bias"] = bias.at[C:].set(1.0)
    return params


def test_sampled_z0_matches_jax(monkeypatch):
    """z_sample with the same eps on both sides, and the KL term:
    loss = mse + z_kl_weight * z0_kl on each side."""
    eps = torch.randn((B, 4, 4, C), generator=torch.Generator().manual_seed(
        11)).numpy()
    metrics, port = _model_parity(["defaults", "train_mmnist_sample_odecgru"],
                                  eps=eps, monkeypatch=monkeypatch,
                                  tweak=_std_bias_one)
    assert port.z_sample and port.z_kl_weight == 0.01
    batch = make_batch_dict(t32(_video()), T_IN)
    with torch.no_grad():
        enc = port.conv_encoder(batch["observed_data"].reshape(
            B * T_IN, S, S, 1) + 0.5).reshape(B, T_IN, 4, 4, C)
        _, std = port.z0_encoder(enc, batch["observed_tp"])
    assert float(std.min()) > 1e-3
    loss = float(metrics["mse"]) + 0.01 * float(metrics["z0_kl"])
    assert abs(float(metrics["loss"]) / loss - 1.0) <= 1e-6
    with pytest.raises(ValueError, match="generator"):
        port.predict(make_batch_dict(t32(_video()), T_IN))
