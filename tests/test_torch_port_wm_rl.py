"""The Dreamer RL loop's pieces in the port against the JAX package.

* ControlledDigit: ``reset`` with JAX's draws replayed, ``render`` at
  positions on half pixels (both round half to even) and at the canvas'
  edges, ``step`` with actions beyond [-1, 1], bit for bit;
  ``collect_random`` with JAX's draws replayed: the actions bit for bit,
  the frames and rewards to 1e-7 max abs (the jitted JAX divides by 255
  and by 36 as a multiplication by the reciprocal: readings 6e-8 and
  1.5e-8), the sprites on the same pixels;
* ``ActionHead`` ('tanh_normal' and 'onehot'): stats, a replayed sample,
  the mode, ``log_prob`` (at the sample and at actions beyond the
  +-0.999 clip) and the entropy to 1e-5 max abs, their gradients to 1e-4
  of each leaf's norm;
* one ``ImagBehavior`` train step against JAX's ``make_train_step``
  ('dynamics' with 'tanh_normal' through a Gaussian RSSM; 'reinforce'
  with 'onehot' through a discrete one), JAX's init and draws: the
  metrics to 1e-5 relative, the actor's, value's and slow value's
  parameters to 1e-6 max abs (one Adam step of lr 1e-3 moves each by
  about 1e-3), the world model's unchanged; then the slow value copied
  every ``slow_target_update`` updates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (DrawReplay, assert_leaves_close, load_typed,
                             max_abs, np32, rssm_noise, t32, typed_grads)
from ode_rl_torch.wm import envs
from ode_rl_torch.wm.behavior import (ActionHead, ImagBehavior,
                                      rssm_behavior_fns)
from ode_rl_torch.wm.rssm import RSSM

BANK = np.random.RandomState(0).randint(0, 256, (5, 28, 28)).astype(np.uint8)


def _f32(a):
    return np.asarray(a, np.float32)


def _reset_draws(key, batch):
    k1, k2 = jax.random.split(key)
    return [("randint", np.asarray(jax.random.randint(
        k1, (batch,), 0, BANK.shape[0]))),
        ("uniform", _f32(jax.random.uniform(k2, (batch, 2), minval=0.0,
                                            maxval=envs.POS_MAX)))]


def test_env_reset_render_step_match_jax():
    from ode_rl_tpu.wm import envs as jenvs
    key = jax.random.key(4)
    jstate = jenvs.reset(key, jnp.asarray(BANK), 6)
    state = envs.reset(DrawReplay(_reset_draws(key, 6)),
                       torch.from_numpy(BANK), 6)
    assert np.array_equal(state["idx"].numpy(), np.asarray(jstate["idx"]))
    assert np.array_equal(np32(state["pos"]), np.asarray(jstate["pos"]))
    # Half pixels round to even (2.5 -> 2, 3.5 -> 4); the edges clip.
    pos = np.array([[2.5, 3.5], [0.5, 1.5], [35.5, 36.0], [-3.0, 40.0],
                    [17.49, 17.51], [12.0, 33.5]], np.float32)
    jstate = {"idx": jnp.asarray([0, 1, 2, 3, 4, 0]),
              "pos": jnp.asarray(pos)}
    state = {"idx": torch.tensor([0, 1, 2, 3, 4, 0]), "pos": t32(pos)}
    frame = envs.render(state, torch.from_numpy(BANK))
    assert np.array_equal(np32(frame), np.asarray(
        jenvs.render(jstate, jnp.asarray(BANK))))
    # x 2.5 -> column 2, y 3.5 -> row 4.
    assert np.array_equal(np32(frame[0, 4:32, 2:30, 0]),
                          BANK[0].astype(np.float32) / 255.0 - 0.5)
    action = np.random.RandomState(1).uniform(-2, 2, (6, 2)).astype(
        np.float32)
    (jnew, jr), (new, r) = (jenvs.step(jstate, jnp.asarray(action)),
                            envs.step(state, t32(action)))
    assert np.array_equal(np32(new["pos"]), np.asarray(jnew["pos"]))
    assert np.array_equal(np32(r), np.asarray(jr))


def test_collect_random_matches_jax():
    from ode_rl_tpu.wm import envs as jenvs
    key, b, horizon = jax.random.key(9), 3, 5
    ref = jenvs.collect_random(key, jnp.asarray(BANK), batch=b,
                               horizon=horizon)
    k_reset, k_roll = jax.random.split(key)
    draws = _reset_draws(k_reset, b) + [
        ("uniform", _f32(jax.random.uniform(k, (b, 2), minval=-1.0,
                                            maxval=1.0)))
        for k in jax.random.split(k_roll, horizon - 1)]
    noise = DrawReplay(draws)
    ep = envs.collect_random(noise, torch.from_numpy(BANK), b, horizon)
    assert not noise.draws
    for k in ("image", "action", "reward"):
        assert tuple(ep[k].shape) == ref[k].shape, k
        assert max_abs(ep[k], ref[k]) <= 1e-7, k
    # Where each sprite lies (the rounded positions) is equal.
    assert np.array_equal(np32(ep["image"]) > -0.49,
                          np.asarray(ref["image"]) > -0.49)
    # A policy receives each step's observation and the noise.
    seen = []

    def policy(obs, noise):
        seen.append(tuple(obs.shape))
        return torch.full((b, 2), 0.5)

    ep = envs.collect_random(DrawReplay(_reset_draws(k_reset, b)),
                             torch.from_numpy(BANK), b, horizon, policy)
    assert seen == [(b, 64, 64, 1)] * (horizon - 1)
    assert torch.all(ep["action"][:, 1:] == 0.5)


def _action_draw(dist, key, shape):
    if dist == "onehot":
        return ("gumbel", _f32(jax.random.gumbel(key, shape)))
    return ("normal", _f32(jax.random.normal(key, shape)))


@pytest.mark.parametrize("dist", ["tanh_normal", "onehot"])
def test_action_head_matches_jax(dist):
    from ode_rl_tpu.wm.behavior import ActionHead as JaxHead
    rng = np.random.RandomState(2)
    feats = rng.randn(4, 10).astype(np.float32)
    head = JaxHead(action_dim=3, layers=2, units=16, dist=dist)
    variables = head.init(jax.random.key(0), feats)
    key = jax.random.key(5)
    edge = np.array([[1.0, -1.0, 0.9995]] * 4, np.float32)
    if dist == "onehot":
        edge = np.eye(3, dtype=np.float32)[[0, 2, 1, 1]]

    def outs(p):
        stats = head.apply(p, feats)
        sample = head.sample(stats, key)
        return {"stats": stats, "sample": sample, "mode": head.mode(stats),
                "log_prob": head.log_prob(stats, sample),
                "log_prob_edge": head.log_prob(stats, edge),
                "entropy": head.entropy(stats)}

    j_out = outs(variables)
    w = {k: rng.randn(*v.shape).astype(np.float32) for k, v in
         j_out.items()}
    j_grads = jax.grad(lambda p: sum(
        jnp.sum(v * w[k]) for k, v in outs({"params": p}).items()
        if k != "mode"))(variables["params"])
    port = ActionHead(10, 3, layers=2, units=16, dist=dist,
                      generator=torch.Generator())
    load_typed(port, variables["params"])
    stats = port(t32(feats))
    sample = port.sample(stats, DrawReplay([_action_draw(dist, key,
                                                         (4, 3))]))
    ours = {"stats": stats, "sample": sample, "mode": port.mode(stats),
            "log_prob": port.log_prob(stats, sample),
            "log_prob_edge": port.log_prob(stats, t32(edge)),
            "entropy": port.entropy(stats)}
    for k, v in j_out.items():
        assert max_abs(ours[k], v) <= 1e-5 * max(1.0, float(np.max(np.abs(
            np.asarray(v))))), k
    sum((v * t32(w[k])).sum() for k, v in ours.items()
        if k != "mode").backward()
    assert_leaves_close({n: p.grad for n, p in port.named_parameters()},
                        typed_grads(port, j_grads), 1e-4)


A, N, H, STOCH, DETER, E = 2, 3, 4, 4, 16, 12
# (imag_gradient, actor dist, RSSM classes)
BEHAVIORS = [("dynamics", "tanh_normal", 0), ("reinforce", "onehot", 3)]


def _reward_np(feats, actions, xp):
    return xp.tanh(feats).mean(-1) + 0.1 * actions.sum(-1)


def _jax_setup(discrete):
    from ode_rl_tpu.wm.rssm import RSSM as JaxRSSM
    rng = np.random.RandomState(3)
    rssm = JaxRSSM(stoch=STOCH, deter=DETER, hidden=DETER, discrete=discrete)
    embed = jnp.asarray(rng.randn(N, 2, E).astype(np.float32))
    acts = jnp.asarray(rng.uniform(-1, 1, (N, 2, A)).astype(np.float32))
    params = rssm.init(jax.random.key(0), embed, jax.random.key(1),
                       actions=acts, method=rssm.observe)
    post, _ = rssm.apply(params, embed, jax.random.key(2), actions=acts,
                         method=rssm.observe)
    start = jax.tree_util.tree_map(lambda v: v[:, -1], post)
    return rssm, params, start


def _behavior_draws(key, dist, discrete, horizon=H):
    out = []
    for k in jax.random.split(key):
        for kk in jax.random.split(k, horizon):
            ka, kd = jax.random.split(kk)
            out.append(_action_draw(dist, ka, (N, A)))
            out.append(rssm_noise(kd, N, STOCH, discrete))
    return out


def _port_behavior(imag, dist, feat_dim, slow_every=100):
    return ImagBehavior(A, feat_dim, actor_dist=dist, horizon=H, units=16,
                        layers=2, actor_lr=1e-3, value_lr=1e-3,
                        imag_gradient=imag, slow_target_update=slow_every,
                        generator=torch.Generator())


@pytest.mark.parametrize("imag,dist,discrete", BEHAVIORS,
                         ids=[b[0] for b in BEHAVIORS])
def test_imag_behavior_train_step_matches_jax(imag, dist, discrete):
    from ode_rl_tpu.wm.behavior import ImagBehavior as JaxBehavior
    from ode_rl_tpu.wm.behavior import rssm_behavior_fns as jax_fns
    rssm, params, start = _jax_setup(discrete)
    feat_dim = STOCH * max(discrete, 1) + DETER
    jb = JaxBehavior(A, feat_dim, actor_dist=dist, horizon=H, units=16,
                     layers=2, actor_lr=1e-3, value_lr=1e-3,
                     imag_gradient=imag)
    state = jb.init(jax.random.key(4))
    img_step_fn, get_feat_fn = jax_fns(rssm, params)
    step = jb.make_train_step(img_step_fn, get_feat_fn,
                              lambda f, s, a: _reward_np(f, a, jnp))
    key = jax.random.key(6)
    new, j_metrics = step(state, start, key)

    port_rssm = RSSM(E, stoch=STOCH, deter=DETER, hidden=DETER,
                     discrete=discrete, action_dim=A,
                     generator=torch.Generator())
    load_typed(port_rssm, params["params"])
    wm_before = {n: p.detach().clone()
                 for n, p in port_rssm.named_parameters()}
    beh = _port_behavior(imag, dist, feat_dim)
    load_typed(beh.actor, state.actor_params["params"])
    load_typed(beh.value, state.value_params["params"])
    load_typed(beh.slow_value, state.slow_value_params["params"])
    noise = DrawReplay(_behavior_draws(key, dist, discrete))
    metrics = beh.train_step(
        {k: t32(v) for k, v in start.items()}, *rssm_behavior_fns(port_rssm),
        lambda f, s, a: _reward_np(f, a, torch), noise)
    assert not noise.draws
    assert set(metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        assert abs(float(metrics[k]) - float(v)) <= 1e-5 * max(
            abs(float(v)), 1e-2), k
    for module, tree in ((beh.actor, new.actor_params),
                         (beh.value, new.value_params),
                         (beh.slow_value, new.slow_value_params)):
        ref = typed_grads(module, tree["params"])
        for n, p in module.named_parameters():
            assert max_abs(p.detach(), ref[n]) <= 1e-6, n
    for n, p in port_rssm.named_parameters():
        assert torch.equal(p, wm_before[n]), n
    assert beh.updates == int(new.updates) == 1


def test_slow_value_copied_every_n_updates():
    """With ``slow_target_update`` 2 the slow value keeps its weights
    through the first update and takes the value's at the second, as
    JAX's ``jnp.where((updates % n) == 0, ...)``."""
    rssm, params, start = _jax_setup(0)
    port_rssm = RSSM(E, stoch=STOCH, deter=DETER, hidden=DETER,
                     action_dim=A, generator=torch.Generator())
    load_typed(port_rssm, params["params"])
    beh = _port_behavior("dynamics", "tanh_normal", STOCH + DETER,
                         slow_every=2)
    slow0 = {n: p.clone() for n, p in beh.slow_value.state_dict().items()}
    start = {k: t32(v) for k, v in start.items()}
    gen = torch.Generator().manual_seed(0)
    from ode_rl_torch.core.noise import Noise
    fns = rssm_behavior_fns(port_rssm)
    reward = lambda f, s, a: _reward_np(f, a, torch)
    beh.train_step(start, *fns, reward, Noise(gen))
    assert all(torch.equal(p, slow0[n])
               for n, p in beh.slow_value.state_dict().items())
    assert not all(torch.equal(p, slow0[n])
                   for n, p in beh.value.state_dict().items())
    beh.train_step(start, *fns, reward, Noise(gen))
    assert all(torch.equal(p, beh.value.state_dict()[n])
               for n, p in beh.slow_value.state_dict().items())
    assert not any(p.requires_grad for p in beh.slow_value.parameters())
