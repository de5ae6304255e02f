"""Helpers shared by the tests/test_torch_port_*.py parity tests: the same
numpy inputs go through the JAX package and the PyTorch port."""

from __future__ import annotations

import jax
import numpy as np
import torch

from ode_rl_torch.convert import flax_to_torch

# The suite runs under several xdist workers.
torch.set_num_threads(2)


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def t32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def max_abs(a, b) -> float:
    return float(np.max(np.abs(np32(a) - np32(b))))


def rel_l2(a, b) -> float:
    a, b = np32(a), np32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def load_flax(module: torch.nn.Module, flax_params) -> dict:
    """Load converted flax params into ``module``; return the numpy tree."""
    tree = jax.tree_util.tree_map(np.asarray, flax_params)
    module.load_state_dict(flax_to_torch(tree), strict=True)
    return tree


def torch_grads(module: torch.nn.Module) -> dict:
    return {name: p.grad for name, p in module.named_parameters()}


def flax_grads_as_torch(flax_grads) -> dict:
    """flax gradient tree -> the port's layout and names."""
    tree = jax.tree_util.tree_map(np.asarray, flax_grads)
    return flax_to_torch(tree)


def assert_grads_close(module: torch.nn.Module, flax_grads, tol: float,
                       metric=rel_l2) -> None:
    ref = flax_grads_as_torch(flax_grads)
    ours = torch_grads(module)
    assert set(ref) == set(ours)
    for name in ref:
        err = metric(ours[name], ref[name])
        assert err <= tol, f"{name}: {err:.3g} > {tol}"
