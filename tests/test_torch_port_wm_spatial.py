"""The spatial RSSM in the port against the JAX package.

``StochasticConvGRUCell`` on 4x5 maps, with JAX's uniform replayed and
with ``key=None``, and ``SpatialWorldModel`` (stoch 4, deter, hidden and
embed 8) on B=2, T=4 frames of 16x16x1 (4x4 maps), with and without the
stochastic gates: its loss and ``predict``. JAX's init is carried by
``convert.py`` with the port's module (the cell's ``update``, ``reset``
and ``out`` as ``Conv``, the decoder's as ``ConvTranspose``); JAX's
draws are replayed from the keys its ``observe`` and ``imagine``
receive (tests/torch_port_util.py), in the order the port's docstring
states.

Tolerances (fp32 on both sides): losses and metrics 1e-5 relative;
outputs and predictions 1e-5 max abs; every gradient leaf 1e-4 of its
norm (relative L2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (DrawReplay, assert_leaves_close, load_typed,
                             max_abs, spatial_imagine_draws,
                             spatial_observe_draws, t32, typed_grads)
from test_torch_port_wm_models import (B, GEN, GRAD_TOL, LOSS_TOL, OUT_TOL,
                                       T, _grads, _record)
from ode_rl_torch.wm.spatial_rssm import (SpatialWorldModel,
                                          StochasticConvGRUCell)


@pytest.mark.parametrize("with_key", [True, False], ids=["key", "no_key"])
def test_stochastic_convgru_cell_matches_jax(with_key):
    """The cell on 4x5 maps (the gate head's rows in (h, w) order) with
    JAX's uniform replayed, and with ``key=None`` (the probability as the
    sample): its four outputs and every gradient leaf."""
    from ode_rl_tpu.wm.spatial_rssm import StochasticConvGRUCell as JaxCell
    rng = np.random.RandomState(5)
    c = 6
    h = rng.randn(B, 4, 5, c).astype(np.float32)
    x = rng.randn(B, 4, 5, 3).astype(np.float32)
    us = (rng.rand(B, c) > 0.5).astype(np.float32)
    up = rng.rand(B, c).astype(np.float32)
    key = jax.random.key(7) if with_key else None
    jc = JaxCell(hidden_dim=c)
    variables = jc.init(jax.random.key(0), h, us, up, x, key)
    port = StochasticConvGRUCell(3, c, 20, generator=GEN())
    load_typed(port, variables["params"])
    j_out = jc.apply(variables, h, us, up, x, key)
    ws = [rng.randn(*o.shape).astype(np.float32) for o in j_out]
    j_grads = jax.grad(lambda p: sum(jnp.sum(o * w) for o, w in zip(
        jc.apply({"params": p}, h, us, up, x, key), ws)))(
            variables["params"])
    noise = (DrawReplay([("uniform", np.asarray(jax.random.uniform(
        key, (B, c)), np.float32))]) if with_key else None)
    out = port(t32(h), t32(us), t32(up), t32(x), noise)
    for a, b in zip(out, j_out):
        assert max_abs(a, b) <= OUT_TOL
    sum((o * t32(w)).sum() for o, w in zip(out, ws)).backward()
    assert_leaves_close(_grads(port), typed_grads(port, j_grads), GRAD_TOL)
    biases = {n: float(getattr(port, n).bias.mean()) for n in
              ("update", "reset", "out")}
    fresh = StochasticConvGRUCell(3, c, 20, generator=GEN())
    assert {n: float(getattr(fresh, n).bias.mean()) for n in biases} == {
        "update": 1.0, "reset": 1.0, "out": 0.0}
    w = fresh.update.weight.permute(2, 3, 1, 0).reshape(-1, c)
    assert torch.allclose(w.T @ w, torch.eye(c), atol=1e-5)


SPATIAL = dict(image_shape=(16, 16, 1), stoch_ch=4, deter_ch=8, hidden_ch=8,
               embed_ch=8)


@pytest.mark.parametrize("gates", [True, False], ids=["gates", "no_gates"])
def test_spatial_world_model_matches_jax(gates):
    """The loss, its metrics, the image means and every gradient leaf,
    then ``predict`` (2 frames after 3)."""
    from ode_rl_tpu.wm.spatial_rssm import SpatialRSSM as JaxRSSM
    from ode_rl_tpu.wm.spatial_rssm import SpatialWorldModel as JaxSWM
    rng = np.random.RandomState(6)
    video = (rng.rand(B, T, 16, 16, 1) - 0.5).astype(np.float32)
    jm = JaxSWM(**SPATIAL, stochastic_gates=gates, kl_free=0.1)
    jb = {"image": jnp.asarray(video)}
    variables = jm.init({"params": jax.random.key(0),
                         "sample": jax.random.key(1)}, jb, method=jm.loss)

    def loss_fn(p):
        return jm.apply({"params": p}, jb, method=jm.loss,
                        rngs={"sample": jax.random.key(5)})

    ((j_loss, (j_metrics, j_pred)), j_grads), keys = _record(
        lambda: jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"]), (JaxRSSM, "observe", 1))
    assert [k[0] for k in keys] == ["observe"]
    port = SpatialWorldModel(**SPATIAL, stochastic_gates=gates, kl_free=0.1,
                             generator=GEN())
    load_typed(port, variables["params"])
    dims = (B, 4, 4, 8, gates)
    noise = DrawReplay(spatial_observe_draws(keys[0][1], T, *dims))
    loss, (metrics, pred) = port.loss({"image": t32(video)}, noise)
    assert not noise.draws
    assert set(metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        ref = float(v)
        assert abs(float(metrics[k]) - ref) <= LOSS_TOL * max(abs(ref),
                                                              1e-2), k
    assert max_abs(pred, j_pred) <= OUT_TOL
    loss.backward()
    assert_leaves_close(_grads(port), typed_grads(port, j_grads), GRAD_TOL)

    batch = {"observed_data": video[:, :3], "data_to_predict": video[:, 3:]}
    (j_pred, _), keys = _record(
        lambda: jax.jit(lambda v: jm.apply(
            v, {k: jnp.asarray(a) for k, a in batch.items()},
            method=jm.predict, rngs={"sample": jax.random.key(6)}))(
                variables),
        (JaxRSSM, "observe", 1), (JaxRSSM, "imagine", 2))
    keys = dict(keys)
    assert set(keys) == {"observe", "imagine"}
    noise = DrawReplay(spatial_observe_draws(keys["observe"], 3, *dims)
                       + spatial_imagine_draws(keys["imagine"], 1, *dims))
    with torch.no_grad():
        pred, _ = port.predict({k: t32(v) for k, v in batch.items()}, noise)
    assert not noise.draws
    assert max_abs(pred, j_pred) <= OUT_TOL
    with pytest.raises(ValueError, match="image_shape"):
        port.loss({"image": torch.zeros(B, T, 32, 32, 1)}, noise)
