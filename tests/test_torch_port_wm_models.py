"""The world models' networks and models in the port against the JAX
package.

Small sizes: depth 8, stoch 4, deter 16, hidden 16 (discrete 4 x 3),
B=2, T=4 of 64x64x1 frames (the encoder's and decoder's 'VALID'
geometry needs 64); the spatial RSSM is in
tests/test_torch_port_wm_spatial.py. JAX's init is carried by
``convert.py`` with the port's module (the encoder's ``h{i}`` as
``Conv``, the decoder's as ``ConvTransposeValid``); JAX's draws are
replayed from the keys its ``observe`` and ``imagine`` receive, recorded
by wrapping them (tests/torch_port_util.py).

Tolerances (fp32 on both sides): losses and metrics 1e-5 relative;
outputs and predictions 1e-5 max abs; every gradient leaf 1e-4 of its
norm (relative L2). The schedules 1e-6 relative, the lambda-returns
1e-5 max abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (DrawReplay, KeyRecorder, assert_leaves_close,
                             load_typed, max_abs, np32, rssm_imagine_draws,
                             rssm_observe_draws, t32, typed_grads)
from ode_rl_torch.wm import networks, tools
from ode_rl_torch.wm.world_model import DreamerVideoModel, WorldModel

B, T, DEPTH, STOCH, DETER, A = 2, 4, 8, 4, 16, 2
OUT_TOL, LOSS_TOL, GRAD_TOL = 1e-5, 1e-5, 1e-4
GEN = lambda: torch.Generator().manual_seed(0)


def _grads(module) -> dict:
    return {n: p.grad for n, p in module.named_parameters()}


def _net_parity(jnet, port, inputs):
    """Outputs and parameter gradients of sum(out * w), JAX's init."""
    variables = jnet.init(jax.random.key(0), *inputs)
    load_typed(port, variables["params"])
    shape = jax.eval_shape(lambda: jnet.apply(variables, *inputs)).shape
    w = np.random.RandomState(9).randn(*shape).astype(np.float32)

    def loss(p):
        out = jnet.apply({"params": p}, *inputs)
        return jnp.sum(out * w), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    out = port(*[t32(a) for a in inputs])
    assert tuple(out.shape) == j_out.shape
    assert max_abs(out, j_out) <= OUT_TOL * max(1.0, float(np.max(np.abs(
        np.asarray(j_out)))))
    (out * t32(w)).sum().backward()
    assert_leaves_close(_grads(port), typed_grads(port, j_grads), GRAD_TOL)


def test_conv_encoder_flattens_nhwc_as_flax():
    from ode_rl_tpu.wm.networks import ConvEncoder
    x = np.random.RandomState(0).rand(B, T, 64, 64, 1).astype(np.float32)
    port = networks.ConvEncoder(1, DEPTH, generator=GEN())
    _net_parity(ConvEncoder(depth=DEPTH), port, [x - 0.5])
    assert networks.encoder_size((64, 64, 1), DEPTH) == 32 * DEPTH


def test_conv_decoder_valid_stride2_transposed_convs():
    """flax's 'VALID' stride-2 transposed convs, kernels 5, 5, 6, 6:
    1 -> 5 -> 13 -> 30 -> 64, as conv_transpose2d with the kernel
    flipped (convert.py by the ``ConvTransposeValid`` type)."""
    from ode_rl_tpu.wm.networks import ConvDecoder
    f = np.random.RandomState(1).randn(B, T, 20).astype(np.float32)
    port = networks.ConvDecoder(20, DEPTH, generator=GEN())
    _net_parity(ConvDecoder(depth=DEPTH), port, [f])
    assert isinstance(port.h3, networks.ConvTransposeValid)
    sizes, x = [], torch.zeros(1, 1, 1, 32 * DEPTH)
    for i in range(4):
        x = getattr(port, f"h{i}")(x)
        sizes.append(x.shape[1])
    assert sizes == [5, 13, 30, 64]


@pytest.mark.parametrize("dist", ["normal", "binary", "huber"])
@pytest.mark.parametrize("shape", [(), (3,)])
def test_dense_head_log_prob_matches_jax(dist, shape):
    from ode_rl_tpu.wm.networks import DenseHead
    rng = np.random.RandomState(2)
    f = rng.randn(B, T, 10).astype(np.float32)
    target = (rng.rand(B, T, *shape) > 0.5 if dist == "binary"
              else rng.randn(B, T, *shape)).astype(np.float32)
    jh = DenseHead(shape=shape, layers=2, units=16, dist=dist, std=1.5)
    variables = jh.init(jax.random.key(0), f)
    port = networks.DenseHead(10, shape, 2, 16, dist=dist, std=1.5,
                              generator=GEN())
    load_typed(port, variables["params"])
    mean = jh.apply(variables, f)
    j_lp = jh.apply(variables, mean, target, method=jh.log_prob)
    ours = port(t32(f))
    assert max_abs(ours, mean) <= OUT_TOL
    lp = port.log_prob(ours, t32(target))
    assert tuple(lp.shape) == (B, T)
    assert max_abs(lp, j_lp) <= OUT_TOL * max(1.0, float(np.max(np.abs(
        np.asarray(j_lp)))))


def _wm_kwargs(discrete: int) -> dict:
    return dict(image_shape=(64, 64, 1), cnn_depth=DEPTH, stoch=STOCH,
                deter=DETER, hidden=DETER, discrete=discrete,
                pred_reward=True, pred_discount=True)


def _episode(seed: int = 3) -> dict:
    rng = np.random.RandomState(seed)
    return {"image": (rng.rand(B, T, 64, 64, 1) - 0.5).astype(np.float32),
            "action": rng.uniform(-1, 1, (B, T, A)).astype(np.float32),
            "reward": rng.rand(B, T).astype(np.float32),
            "discount": (rng.rand(B, T) > 0.3).astype(np.float32)}


def _record(model_fn, *wrap):
    """Run ``model_fn`` with the listed (class, method, key index)
    wrapped; returns (its result, the recorded keys)."""
    rec = KeyRecorder()
    with pytest.MonkeyPatch.context() as mp:
        for cls, name, index in wrap:
            rec.wrap(mp, cls, name, index)
        out = model_fn()
    return out, rec.keys


@pytest.mark.parametrize("discrete", [0, 3], ids=["gaussian", "discrete"])
def test_world_model_loss_with_actions_and_heads_matches_jax(discrete):
    """``WorldModel.loss`` with actions, reward and discount heads and
    KL free bits 0.01 (so the KL's gradient passes): the loss, every
    metric, the image means and every gradient leaf."""
    from ode_rl_tpu.wm.rssm import RSSM as JaxRSSM
    from ode_rl_tpu.wm.world_model import WorldModel as JaxWM
    ep = _episode()
    jb = {k: jnp.asarray(v) for k, v in ep.items()}
    jm = JaxWM(**_wm_kwargs(discrete), kl_free=0.01)
    variables = jm.init({"params": jax.random.key(0),
                         "sample": jax.random.key(1)}, jb, method=jm.loss)

    def loss_fn(p):
        loss, (metrics, pred) = jm.apply({"params": p}, jb, method=jm.loss,
                                         rngs={"sample": jax.random.key(5)})
        return loss, (metrics, pred)

    ((j_loss, (j_metrics, j_pred)), j_grads), keys = _record(
        lambda: jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"]), (JaxRSSM, "observe", 1))
    assert [k[0] for k in keys] == ["observe"]
    port = WorldModel(**_wm_kwargs(discrete), kl_free=0.01, action_dim=A,
                      generator=GEN())
    load_typed(port, variables["params"])
    noise = DrawReplay(rssm_observe_draws(keys[0][1], T, B, STOCH,
                                          discrete))
    loss, (metrics, pred) = port.loss({k: t32(v) for k, v in ep.items()},
                                      noise)
    assert not noise.draws
    assert set(metrics) == set(j_metrics) >= {
        "loss", "kl_loss", "kl", "prior_ent", "post_ent", "kl_free",
        "kl_scale", "image_loss", "reward_loss", "discount_loss"}
    for k, v in j_metrics.items():
        ref = float(v)
        assert abs(float(metrics[k]) - ref) <= LOSS_TOL * max(abs(ref),
                                                              1e-2), k
    assert float(metrics["kl"]) > 0.01        # the free bits do not bind
    assert max_abs(pred, j_pred) <= OUT_TOL
    loss.backward()
    assert_leaves_close(_grads(port), typed_grads(port, j_grads), GRAD_TOL)


def test_dreamer_video_model_predict_matches_jax():
    """The open-loop prediction of 2 frames after 3: ``observe`` over all
    5 frames, then ``imagine`` from the third posterior."""
    from ode_rl_tpu.wm.rssm import RSSM as JaxRSSM
    from ode_rl_tpu.wm.world_model import DreamerVideoModel as JaxDVM
    rng = np.random.RandomState(4)
    video = (rng.rand(B, 5, 64, 64, 1) - 0.5).astype(np.float32)
    batch = {"observed_data": video[:, :3], "data_to_predict": video[:, 3:]}
    kw = dict(_wm_kwargs(3), pred_reward=False, pred_discount=False)
    jm = JaxDVM(**kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jm.init({"params": jax.random.key(0),
                         "sample": jax.random.key(1)}, jb, method=jm.loss)
    (j_pred, _), keys = _record(
        lambda: jax.jit(lambda v: jm.apply(
            v, jb, method=jm.predict,
            rngs={"sample": jax.random.key(6)}))(variables),
        (JaxRSSM, "observe", 1), (JaxRSSM, "imagine", 2))
    keys = dict(keys)
    assert set(keys) == {"observe", "imagine"}
    port = DreamerVideoModel(**kw, generator=GEN())
    load_typed(port, variables["params"])
    noise = DrawReplay(rssm_observe_draws(keys["observe"], 5, B, STOCH, 3)
                       + rssm_imagine_draws(keys["imagine"], 2, B, STOCH, 3))
    with torch.no_grad():
        pred, aux = port.predict({k: t32(v) for k, v in batch.items()},
                                 noise)
    assert not noise.draws and aux == {}
    assert tuple(pred.shape) == (B, 2, 64, 64, 1)
    assert max_abs(pred, j_pred) <= OUT_TOL


def test_schedule_and_lambda_return_match_jax():
    from ode_rl_tpu.wm import tools as jax_tools
    for spec in (0.3, 2, "0.7", "linear(1.0,0.1,100)", "warmup(50,2.0)",
                 "exp(1.0,0.1,30)", "horizon(2,20,100)"):
        for step in (0, 7, 50, 100, 250):
            ref = float(jax_tools.schedule(spec, step))
            got = tools.schedule(spec, step)
            assert isinstance(got, float)
            assert abs(got - ref) <= 1e-6 * max(abs(ref), 1.0), (spec, step)
    with pytest.raises(NotImplementedError):
        tools.schedule("cosine(1,2)", 0)
    rng = np.random.RandomState(7)
    r, v, p = (rng.randn(6, 3).astype(np.float32) for _ in range(3))
    boot = rng.randn(3).astype(np.float32)
    ref = jax_tools.lambda_return(r, v, p, boot, 0.95)
    assert max_abs(tools.lambda_return(t32(r), t32(v), t32(p), t32(boot),
                                       0.95), ref) <= OUT_TOL
    ref = jax_tools.lambda_return(r.T, v.T, p.T, boot, 0.9, axis=1)
    assert max_abs(tools.lambda_return(t32(r.T), t32(v.T), t32(p.T),
                                       t32(boot), 0.9, axis=1),
                   ref) <= OUT_TOL
    every, once, until = tools.Every(3), tools.Once(), tools.Until(5)
    assert [every(s) for s in range(7)] == [True, False, False, True,
                                            False, False, True]
    assert [once(), once()] == [True, False]
    assert [until(4), until(5), tools.Until(0)(10**6)] == [True, False,
                                                           True]


def test_one_hot_st_sample_matches_jax_categorical():
    """The argmax of logits plus JAX's Gumbels is
    ``jax.random.categorical``'s sample; the straight-through gradient is
    the softmax's."""
    rng = np.random.RandomState(8)
    logits = rng.randn(5, 4, 7).astype(np.float32)
    key = jax.random.key(3)
    ref = jax.nn.one_hot(jax.random.categorical(key, logits), 7)
    g = np.asarray(jax.random.gumbel(key, logits.shape), np.float32)
    lg = t32(logits).requires_grad_()
    out = tools.one_hot_st_sample(DrawReplay([("gumbel", g)]), lg)
    assert np.array_equal(np32(out.detach()).round(), np.asarray(ref))
    w = t32(rng.randn(5, 4, 7))
    (out * w).sum().backward()
    probs = torch.softmax(t32(logits), -1)
    expect = probs * (w - (probs * w).sum(-1, keepdim=True))
    assert max_abs(lg.grad, expect) <= 1e-6
