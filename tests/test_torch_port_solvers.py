"""``odeint_aux`` of the PyTorch port against the JAX package's, every
method, on a small conv field (batch 2, 6x6, 4 channels) with a time-
dependent term, so that dopri5 rejects steps.

Tolerances: the solution to 1e-5 of its largest magnitude (max abs), the
stats equal, the gradients with respect to y0 and every parameter to 1e-4
relative L2. dopri5's step sizes follow the error ratio continuously,
and the ratio is a difference of nearly equal stage sums, so fp32
rounding that differs between XLA:CPU and torch moves dt a little: the
cases keep the error estimate far above fp32 noise (ROADMAP queue 3), and
the truncated ones stop where the budget runs out with equal stats.
Checkpointing each attempt (``remat``) must not change the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_util import max_abs, rel_l2, t32
from ode_rl_torch.ode.solvers import odeint_aux

B, S, C = 2, 6, 4
TS = np.linspace(0.0, 1.0, 9, dtype=np.float32)


def _problem():
    rng = np.random.RandomState(0)
    params = {"w1": rng.randn(3, 3, C, C).astype(np.float32) * 0.3,
              "b1": rng.randn(C).astype(np.float32) * 0.1,
              "w2": rng.randn(3, 3, C, C).astype(np.float32) * 0.3,
              "a": np.float32(3.0)}
    y0 = rng.uniform(-1, 1, (B, S, S, C)).astype(np.float32)
    w = rng.randn(len(TS), B, S, S, C).astype(np.float32)
    return params, y0, w


def _jconv(x, k):
    return jax.lax.conv_general_dilated(
        x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _jax_field(p):
    return lambda t, y: (p["a"] * jnp.cos(12.0 * t) * y
                         + _jconv(jnp.tanh(_jconv(y, p["w1"]) + p["b1"]),
                                  p["w2"]))


def _tconv(x, k):
    return F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


def _torch_field(p):
    def f(t, y):
        t = torch.as_tensor(t, dtype=torch.float32)
        return (p["a"] * torch.cos(12.0 * t) * y
                + _tconv(torch.tanh(_tconv(y, p["w1"]) + p["b1"]), p["w2"]))
    return f


def _jax_solve(kw):
    from ode_rl_tpu.ode.solvers import odeint_aux as jax_odeint

    params, y0, w = _problem()

    def loss(y0, p):
        ys, stats = jax_odeint(_jax_field(p), y0, jnp.asarray(TS), **kw)
        return jnp.sum(ys * w), (ys, stats)

    (_, (ys, stats)), grads = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(y0), {k: jnp.asarray(v) for k, v in params.items()})
    return np.asarray(ys), tuple(int(s) for s in stats), grads


def _torch_solve(kw):
    params, y0, w = _problem()
    ty0 = t32(y0).requires_grad_(True)
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in params.items()}
    ys, stats = odeint_aux(_torch_field(tp), ty0, TS, **kw)
    torch.sum(ys * t32(w)).backward()
    return ys, stats, ty0.grad, {k: v.grad for k, v in tp.items()}


# name -> (solver kw, expected (naccept, nreject, converged)).
_CASES = {
    "dopri5": (dict(method="dopri5", rtol=1e-3, atol=1e-5, max_steps=64),
               (7, 2, True)),
    "dopri5_first_step": (dict(method="dopri5", rtol=1e-3, atol=1e-5,
                               max_steps=64, first_step=0.05), (7, 2, True)),
    "dopri5_truncated": (dict(method="dopri5", rtol=3e-3, atol=1e-4,
                              max_steps=5), (4, 1, False)),
    "dopri5_truncated_early": (dict(method="dopri5", rtol=1e-2, atol=1e-3,
                                    max_steps=3), (2, 1, False)),
    "euler_1": (dict(method="euler", substeps=1), (8, 0, True)),
    "euler_2": (dict(method="euler", substeps=2), (16, 0, True)),
    "midpoint_1": (dict(method="midpoint", substeps=1), (8, 0, True)),
    "midpoint_2": (dict(method="midpoint", substeps=2), (16, 0, True)),
    "rk4_1": (dict(method="rk4", substeps=1), (8, 0, True)),
    "rk4_2": (dict(method="rk4", substeps=2), (16, 0, True)),
    "adams": (dict(method="adams"), (8, 0, True)),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_odeint_aux_matches_jax(name):
    kw, expected = _CASES[name]
    j_ys, j_stats, j_grads = _jax_solve(kw)
    ys, stats, g_y0, g_p = _torch_solve(kw)
    assert tuple(ys.shape) == j_ys.shape
    assert max_abs(ys, j_ys) <= 1e-5 * np.abs(j_ys).max()
    assert (stats.naccept, stats.nreject, stats.converged) == expected
    assert (stats.nfe, stats.naccept, stats.nreject,
            int(stats.converged)) == j_stats
    assert rel_l2(g_y0, j_grads[0]) <= 1e-4
    for k, g in g_p.items():
        assert rel_l2(g, j_grads[1][k]) <= 1e-4, k


def test_truncated_solve_fills_unreached_slots_with_the_final_state():
    """The budget stops the solve before ts[-1]: the slots it never
    reached hold the final state, and their cotangent reaches it."""
    kw = dict(_CASES["dopri5_truncated_early"][0])
    params, y0, _ = _problem()
    tp = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    ty0 = t32(y0).requires_grad_(True)
    ys, stats = odeint_aux(_torch_field(tp), ty0, TS, **kw)
    assert not stats.converged
    reached = [i for i in range(1, len(TS))
               if not torch.equal(ys[i], ys[-1])]
    last = max(reached) + 1
    assert 1 < last < len(TS) - 1
    for i in range(last, len(TS)):
        assert torch.equal(ys[i], ys[-1])
    # d(sum of the unreached slots)/dy0 = (number of slots) x d(y_f)/dy0.
    (g_all,) = torch.autograd.grad(ys[last:].sum(), ty0, retain_graph=True)
    (g_one,) = torch.autograd.grad(ys[-1].sum(), ty0)
    assert rel_l2(g_all, (len(TS) - last) * g_one) <= 1e-6


@pytest.mark.parametrize("name", ["dopri5", "dopri5_truncated"])
def test_remat_gives_the_same_gradients(name):
    kw = _CASES[name][0]
    ys_r, stats_r, gy_r, gp_r = _torch_solve({**kw, "remat": True})
    ys_n, stats_n, gy_n, gp_n = _torch_solve({**kw, "remat": False})
    assert torch.equal(ys_r, ys_n) and stats_r == stats_n
    assert torch.equal(gy_r, gy_n)
    for k in gp_r:
        assert torch.equal(gp_r[k], gp_n[k]), k


def test_rejected_attempts_leave_no_graph():
    """Only accepted attempts stay reachable from the output: the graph
    holds (naccept + 1) x 2 evaluations of the field's first conv."""
    params, y0, _ = _problem()
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in params.items()}
    kw = dict(_CASES["dopri5"][0], remat=False)
    ys, stats = odeint_aux(_torch_field(tp), t32(y0), TS, **kw)
    assert stats.nreject > 0
    seen, stack, convs = set(), [ys.grad_fn], 0
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        convs += "Convolution" in type(node).__name__
        stack.extend(n for n, _ in node.next_functions)
    # Each field evaluation runs two convs; f0 plus six stages an accepted
    # attempt.
    assert convs == 2 * (1 + 6 * stats.naccept)


def test_single_time_returns_y0_and_unknown_method_raises():
    y0 = torch.ones(2, 3)
    ys, stats = odeint_aux(lambda t, y: y, y0, np.zeros(1, np.float32))
    assert ys.shape == (1, 2, 3) and stats.converged and stats.nfe == 0
    with pytest.raises(ValueError, match="unknown method"):
        odeint_aux(lambda t, y: y, y0, TS, method="bdf")
