"""The RSSM of the world models in the port against the JAX package.

Small sizes (B=2, T=5, embed 12, stoch 4, deter 16, hidden 16; discrete
4 x 3 classes): the same numpy inputs and JAX's init (``convert.py``
with the port's module) through ``ode_rl_tpu/wm/rssm.py`` and
``ode_rl_torch/wm/rssm.py``. JAX's draws are replayed: they are computed
here from the keys JAX's ``observe`` and ``imagine`` receive, in the
order the port's docstring states (tests/torch_port_util.py), so a port
that drew in another order, or a JAX whose draws differ from that
statement, fails.

Tolerances (fp32 on both sides): outputs (every leaf of post, prior and
the imagined states) 1e-5 max abs; the KL loss and entropy 1e-5
relative; every parameter's (or input's) gradient 1e-4 of its norm
(relative L2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (DrawReplay, assert_leaves_close, load_typed,
                             max_abs, np32, rel_l2, rssm_imagine_draws,
                             rssm_observe_draws, t32, typed_grads)
from ode_rl_torch.wm.rssm import RSSM, NormGRUCell

B, T, E, STOCH, DETER, HIDDEN, N_IMAGINE = 2, 5, 12, 4, 16, 16, 3
OUT_TOL, LOSS_TOL, GRAD_TOL = 1e-5, 1e-5, 1e-4


def test_norm_gru_cell_matches_jax():
    from ode_rl_tpu.wm.rssm import NormGRUCell as JaxCell

    rng = np.random.RandomState(0)
    x, h = rng.randn(3, 7).astype(np.float32), rng.randn(3, 9).astype(
        np.float32)
    for norm in (True, False):
        jcell = JaxCell(size=9, norm=norm)
        variables = jcell.init(jax.random.key(0), x, h)
        cell = NormGRUCell(7, 9, norm=norm,
                           generator=torch.Generator().manual_seed(0))
        load_typed(cell, variables["params"])
        w = rng.randn(3, 9).astype(np.float32)
        j_out = jcell.apply(variables, x, h)
        j_grads = jax.grad(lambda p: jnp.sum(
            jcell.apply({"params": p}, x, h) * w))(variables["params"])
        ours = cell(t32(x), t32(h))
        assert max_abs(ours, j_out) <= OUT_TOL
        (ours * t32(w)).sum().backward()
        assert_leaves_close({n: p.grad for n, p in cell.named_parameters()},
                            typed_grads(cell, j_grads), GRAD_TOL)


# (id, discrete, mean_act, std_act, actions, layers_output, temp_post)
CASES = [
    ("softplus", 0, "none", "softplus", False, 1, True),
    ("abs_actions", 0, "none", "abs", True, 1, True),
    ("sigmoid_tanh5", 0, "tanh5", "sigmoid", False, 1, True),
    ("sigmoid2_actions_2out", 0, "none", "sigmoid2", True, 2, True),
    ("sigmoid2_no_temp_post", 0, "none", "sigmoid2", False, 1, False),
    ("discrete", 3, "none", "softplus", False, 1, True),
    ("discrete_actions", 3, "none", "softplus", True, 1, True),
]
A = 2


def _jax_rssm(discrete, mean_act, std_act, layers_output, temp_post):
    from ode_rl_tpu.wm.rssm import RSSM as JaxRSSM
    return JaxRSSM(stoch=STOCH, deter=DETER, hidden=HIDDEN,
                   discrete=discrete, mean_act=mean_act, std_act=std_act,
                   layers_output=layers_output, temp_post=temp_post)


def _port_rssm(discrete, mean_act, std_act, layers_output, temp_post,
               action_dim):
    return RSSM(E, stoch=STOCH, deter=DETER, hidden=HIDDEN,
                discrete=discrete, mean_act=mean_act, std_act=std_act,
                layers_output=layers_output, temp_post=temp_post,
                action_dim=action_dim,
                generator=torch.Generator().manual_seed(0))


def _flat(post, prior, imagined) -> dict:
    return {**{f"post.{k}": v for k, v in post.items()},
            **{f"prior.{k}": v for k, v in prior.items()},
            **{f"imagined.{k}": v for k, v in imagined.items()}}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_rssm_observe_imagine_match_jax(case):
    _, discrete, mean_act, std_act, with_actions, layers_output, temp_post = (
        case)
    rng = np.random.RandomState(1)
    embed = rng.randn(B, T, E).astype(np.float32)
    actions = (rng.uniform(-1, 1, (B, T, A)).astype(np.float32)
               if with_actions else None)
    im_actions = rng.uniform(-1, 1, (N_IMAGINE, B, A)).astype(np.float32)
    jr = _jax_rssm(discrete, mean_act, std_act, layers_output, temp_post)
    k_obs, k_im = jax.random.key(11), jax.random.key(12)
    variables = jr.init(jax.random.key(0), jnp.asarray(embed), k_obs,
                        actions=None if actions is None
                        else jnp.asarray(actions), method=jr.observe)

    def run(params):
        post, prior = jr.apply(
            {"params": params}, jnp.asarray(embed), k_obs,
            actions=None if actions is None else jnp.asarray(actions),
            method=jr.observe)
        state = jax.tree_util.tree_map(lambda v: v[:, -1], post)
        if actions is None:
            im = jr.apply({"params": params}, N_IMAGINE, state, k_im,
                          method=jr.imagine)
        else:
            # JAX's imagine takes no action: img_step a step, one key a
            # step (imagine's keys), an action a step.
            steps = []
            for k, a in zip(jax.random.split(k_im, N_IMAGINE), im_actions):
                state = jr.apply({"params": params}, state, k,
                                 action=jnp.asarray(a), method=jr.img_step)
                steps.append(state)
            im = jax.tree_util.tree_map(lambda *v: jnp.stack(v, 1), *steps)
        return _flat(post, prior, im)

    shapes = jax.eval_shape(run, variables["params"])
    weights = {k: rng.randn(*v.shape).astype(np.float32)
               for k, v in sorted(shapes.items())}

    def weighted(p):
        out = run(p)
        return sum(jnp.sum(v * weights[k]) for k, v in out.items()), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(weighted, has_aux=True))(
        variables["params"])

    port = _port_rssm(discrete, mean_act, std_act, layers_output, temp_post,
                      A if with_actions else 0)
    load_typed(port, variables["params"])
    draws = (rssm_observe_draws(k_obs, T, B, STOCH, discrete)
             + rssm_imagine_draws(k_im, N_IMAGINE, B, STOCH, discrete))
    noise = DrawReplay(draws)
    post, prior = port.observe(t32(embed), noise, actions=None if actions
                               is None else t32(actions))
    state = {k: v[:, -1] for k, v in post.items()}
    if actions is None:
        im = port.imagine(N_IMAGINE, state, noise)
    else:
        steps = []
        for a in im_actions:
            state = port.img_step(state, noise, action=t32(a))
            steps.append(state)
        im = {k: torch.stack([s[k] for s in steps], 1) for k in state}
    assert not noise.draws, "draws left over"
    ours = _flat(post, prior, im)
    assert set(ours) == set(j_out)
    for k in j_out:
        assert tuple(ours[k].shape) == j_out[k].shape, k
        assert max_abs(ours[k], j_out[k]) <= OUT_TOL, k
    sum((v * t32(weights[k])).sum() for k, v in ours.items()).backward()
    assert_leaves_close({n: p.grad for n, p in port.named_parameters()},
                        typed_grads(port, j_grads), GRAD_TOL)


def _stats(rng, discrete):
    if discrete:
        return {"logit": rng.randn(B, T, STOCH, discrete).astype(np.float32)}
    return {"mean": rng.randn(B, T, STOCH).astype(np.float32),
            "std": (0.1 + rng.rand(B, T, STOCH)).astype(np.float32)}


@pytest.mark.parametrize("discrete", [0, 3], ids=["gaussian", "discrete"])
@pytest.mark.parametrize("balance,forward", [(0.5, False), (0.8, False),
                                             (0.5, True), (0.8, True)])
def test_kl_loss_and_entropy_match_jax(discrete, balance, forward):
    """The loss with free bits 0.5 (below the KL of these stats, so the
    gradient passes) and scale 1.5, the per-sample KL, their gradients
    in the post's and the prior's stats; the entropy of both."""
    rng = np.random.RandomState(2 + discrete)
    post, prior = _stats(rng, discrete), _stats(rng, discrete)
    jr = _jax_rssm(discrete, "none", "softplus", 1, True)
    port = _port_rssm(discrete, "none", "softplus", 1, True, 0)
    free, scale = 0.5, 1.5

    def jax_kl(post, prior):
        loss, value = jr.apply({"params": {}}, post, prior, forward,
                               balance, free, scale, method=jr.kl_loss)
        return loss, value

    (j_loss, j_value), j_vjp = jax.vjp(jax_kl, post, prior)
    w = rng.randn(B, T).astype(np.float32)
    j_gpost, j_gprior = j_vjp((jnp.float32(1.0), jnp.asarray(w)))
    tp = {k: t32(v).requires_grad_() for k, v in post.items()}
    tq = {k: t32(v).requires_grad_() for k, v in prior.items()}
    loss, value = port.kl_loss(tp, tq, forward, balance, free, scale)
    assert float(j_loss) > scale * free      # the free bits do not bind
    assert abs(float(loss.detach()) - float(j_loss)) <= LOSS_TOL * abs(
        float(j_loss))
    assert max_abs(value, j_value) <= OUT_TOL * max(1.0, float(np.max(
        np.abs(np.asarray(j_value)))))
    (loss + (value * t32(w)).sum()).backward()
    for ours, ref in ((tp, j_gpost), (tq, j_gprior)):
        for k in ours:
            assert rel_l2(ours[k].grad, ref[k]) <= GRAD_TOL, k
    for state in (post, prior):
        j_ent = jr.apply({"params": {}}, state, method=jr.entropy)
        ent = port.entropy({k: t32(v) for k, v in state.items()})
        assert rel_l2(ent, j_ent) <= LOSS_TOL


def test_free_bits_floor_matches_jax():
    """Free bits above the KL: the loss is free * scale and passes no
    gradient, on both sides."""
    rng = np.random.RandomState(4)
    post, prior = _stats(rng, 0), _stats(rng, 0)
    jr = _jax_rssm(0, "none", "softplus", 1, True)
    port = _port_rssm(0, "none", "softplus", 1, True, 0)
    j_loss, _ = jr.apply({"params": {}}, post, prior, False, 0.8, 1e4, 1.0,
                         method=jr.kl_loss)
    tp = {k: t32(v).requires_grad_() for k, v in post.items()}
    loss, _ = port.kl_loss(tp, {k: t32(v) for k, v in prior.items()},
                           False, 0.8, 1e4, 1.0)
    assert float(loss.detach()) == float(j_loss) == 1e4
    loss.backward()
    assert all(float(v.grad.abs().max()) == 0.0 for v in tp.values())
    assert np32(loss).dtype == np.float32
