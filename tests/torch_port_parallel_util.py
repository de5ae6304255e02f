"""Helpers of the tests/test_torch_port_parallel_*.py files: each family
of the data-parallel dry run (ode_rl_torch/parallel/dryrun.py) starts
from JAX's weights, batch and draws; its step over 4 spawned gloo ranks
is held against JAX's unsharded step and the port's one-process step at
the dry run's tolerances."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from ode_rl_torch.convert import flax_to_torch
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.parallel import dryrun

RANKS = 4


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_weights(name: str, load) -> dict:
    """The state dict of each of the family's modules after ``load(state)``
    (strict loads of JAX's converted trees)."""
    fam = dryrun.FAMILIES[name]()
    state = fam.build(torch.device("cpu"))
    load(state)
    return {k: {n: t.detach().clone() for n, t in m.state_dict().items()}
            for k, m in fam.modules(state).items()}


def load_named(module: torch.nn.Module, params, batch_stats=None) -> None:
    module.load_state_dict(flax_to_torch(np_tree(params),
                                         None if batch_stats is None
                                         else np_tree(batch_stats)),
                           strict=True)


def load_typed(module: torch.nn.Module, params) -> None:
    module.load_state_dict(flax_to_torch(np_tree(params), module=module),
                           strict=True)


def host_batch(batch: dict) -> dict:
    return {k: v.numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in batch.items()}


def scalars(metrics: dict) -> dict:
    out = {}
    for k, v in metrics.items():
        a = np.asarray(jax.device_get(v))
        if a.ndim == 0:
            out[k] = a.item()
    return out


def video_batches(t: int, seed: int, size: int = 64, **kw):
    """JAX's and the port's (host) batch of one numpy video of B=8 with
    ``t`` frames, 3 of them observed."""
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    rng = np.random.RandomState(seed)
    video = (rng.rand(8, t, size, size, 1) - 0.5).astype(np.float32)
    return (jax_batch(jnp.asarray(video), n_in=3, **kw),
            host_batch(make_batch_dict(torch.from_numpy(video), n_in=3,
                                       **kw)))


def train_state_and_step(model, cfg: dict, jb):
    """JAX's train state from key 0 and its (undonated) train step."""
    from ode_rl_tpu.core.config import Config as JaxConfig
    from ode_rl_tpu.train.step import create_train_state, make_train_step
    state = create_train_state(model, JaxConfig(cfg), jb, jax.random.key(0))
    return state, make_train_step(model, donate=False)


def train_case(name: str, model, cfg: dict, batches, load):
    """The family's inputs (JAX's init loaded by ``load``, the batch) and
    JAX's metrics of one unsharded train step with key 1."""
    jb, pb = batches
    state, step = train_state_and_step(model, cfg, jb)
    _, metrics = step(state, jb, jax.random.key(1))
    weights = port_weights(name, lambda s: load(s.model, state.params))
    return {"weights": weights, "batch": pb}, scalars(metrics)


def first_step_grad_norm(opt_state, b1: float = 0.9) -> float:
    """The global norm of the gradient that an Adam or Adamax optimizer
    took on its first step, read from its state: from zero, its first
    moment is (1 - b1) times the gradient (after any clip before it)."""
    (state,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    assert int(state.count) == 1
    return float(optax.global_norm(state.mu)) / (1.0 - b1)


def run_families(cases: dict) -> dict:
    """``cases``: family -> (inputs, JAX's metrics). Runs them all in one
    spawn of RANKS ranks; returns family -> (result, JAX's metrics)."""
    results = dryrun.run(list(cases), ranks=RANKS, device="cpu",
                         inputs={k: v[0] for k, v in cases.items()},
                         timeout=600)
    return {k: (results[k], v[1]) for k, v in cases.items()}


def tolerance_misses(name: str, got: dict, ref: dict) -> list:
    out = []
    for key, (rtol, atol) in dryrun.FAMILIES[name]().tol.items():
        a, b = float(got[key]), float(ref[key])
        if not abs(a - b) <= atol + rtol * abs(b):
            out.append(f"{key}: {a!r} vs {b!r} (rtol {rtol}, atol {atol})")
    return out
