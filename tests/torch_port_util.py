"""Helpers shared by the tests/test_torch_port_*.py parity tests: the same
numpy inputs go through the JAX package and the PyTorch port."""

from __future__ import annotations

import struct
import zlib

import jax
import jax.numpy as jnp
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


def net_parity(flax_module, port_module, inputs, out_metric=rel_l2,
               out_tol=1e-5, grad_tol=1e-4):
    """Outputs and every parameter gradient of sum(outputs * w) for random
    w, flax vs port, from the same weights (flax's init, converted)."""
    j_inputs = [jnp.asarray(a) for a in inputs]
    variables = flax_module.init(jax.random.key(0), *j_inputs)
    load_flax(port_module, variables["params"])

    def as_list(outs):
        return list(outs) if isinstance(outs, (list, tuple)) else [outs]

    j_outs = as_list(flax_module.apply(variables, *j_inputs))
    rng = np.random.RandomState(7)
    weights = [rng.randn(*o.shape).astype(np.float32) for o in j_outs]

    def loss(params):
        outs = as_list(flax_module.apply({"params": params}, *j_inputs))
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights))

    j_grads = jax.jit(jax.grad(loss))(variables["params"])
    t_outs = as_list(port_module(*[t32(a) for a in inputs]))
    sum(torch.sum(o * t32(w)) for o, w in zip(t_outs, weights)).backward()
    assert [tuple(o.shape) for o in t_outs] == [o.shape for o in j_outs]
    for a, b in zip(t_outs, j_outs):
        assert out_metric(a, b) <= out_tol
    assert_grads_close(port_module, j_grads, grad_tol)


def decode_png(path) -> np.ndarray:
    """A plain decoder: chunks, CRCs, IHDR, the IDAT stream inflated with
    zlib, filter type 0 on every row."""
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == (
            zlib.crc32(kind + body) & 0xFFFFFFFF)
        chunks.append((kind, body))
        pos += 12 + n
    assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    w, h, depth, color = struct.unpack(">IIBB", chunks[0][1][:10])
    assert (depth, color) == (8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)
