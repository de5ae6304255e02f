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
from ode_rl_torch.core.noise import Noise

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


# --- The world models' draws (tests/test_torch_port_wm_*.py) -------------
#
# JAX's world models draw from keys; these compute the arrays a model
# draws from a given key, in the order the port's ``Noise`` is asked for
# them (the modules' docstrings state it), and ``DrawReplay`` hands them
# out. ``KeyRecorder`` records the keys JAX's methods receive, where a
# key comes from flax's ``make_rng``.


class DrawReplay(Noise):
    """The port's ``Noise`` over recorded (kind, array) draws, each
    checked for its kind and shape."""

    def __init__(self, draws):
        super().__init__(None)
        self.draws = list(draws)

    def _next(self, kind, shape):
        assert self.draws, f"no draw left for {kind} {tuple(shape)}"
        got, a = self.draws.pop(0)
        assert got == kind and a.shape == tuple(shape), (got, a.shape,
                                                         kind, tuple(shape))
        return torch.from_numpy(np.array(a))

    def normal(self, shape, like):
        return self._next("normal", shape).to(like.dtype)

    def gumbel(self, shape, like):
        return self._next("gumbel", shape).to(like.dtype)

    def uniform(self, shape, device, low=0.0, high=1.0):
        return self._next("uniform", shape).float()

    def randint(self, low, high, shape, device):
        return self._next("randint", shape).long()


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def rssm_noise(key, b: int, stoch: int, discrete: int):
    if discrete:
        return ("gumbel", _f32(jax.random.gumbel(key, (b, stoch, discrete),
                                                 jnp.float32)))
    return ("normal", _f32(jax.random.normal(key, (b, stoch), jnp.float32)))


def rssm_observe_draws(key, t: int, b: int, stoch: int, discrete: int):
    """``RSSM.observe``: for each step the prior's, then the
    posterior's."""
    out = []
    for k in jax.random.split(key, t):
        k1, k2 = jax.random.split(k)
        out += [rssm_noise(k1, b, stoch, discrete),
                rssm_noise(k2, b, stoch, discrete)]
    return out


def rssm_imagine_draws(key, n: int, b: int, stoch: int, discrete: int):
    return [rssm_noise(k, b, stoch, discrete)
            for k in jax.random.split(key, n)]


def spatial_img_draws(key, b: int, hw: int, stoch: int, deter: int,
                      gates: bool):
    """``SpatialRSSM.img_step``: the gate's uniform, then the normal."""
    ka, kb = jax.random.split(key)
    out = ([("uniform", _f32(jax.random.uniform(ka, (b, deter))))]
           if gates else [])
    return out + [("normal", _f32(jax.random.normal(kb, (b, hw, hw,
                                                         stoch))))]


def spatial_observe_draws(key, t: int, b: int, hw: int, stoch: int,
                          deter: int, gates: bool):
    out = []
    for k in jax.random.split(key, t):
        k1, k2 = jax.random.split(k)
        out += spatial_img_draws(k1, b, hw, stoch, deter, gates)
        out.append(("normal", _f32(jax.random.normal(k2, (b, hw, hw,
                                                          stoch)))))
    return out


def spatial_imagine_draws(key, t: int, b: int, hw: int, stoch: int,
                          deter: int, gates: bool):
    out = []
    for k in jax.random.split(key, t):
        out += spatial_img_draws(k, b, hw, stoch, deter, gates)
    return out


class KeyRecorder:
    """Wraps flax methods so each call's key argument is recorded as
    (method name, key), through ``jax.debug.callback``, so under ``jit``
    too, where the callbacks' order is not the calls'. A callback that
    fires again with the same key (autodiff may replay the forward) is
    recorded once."""

    def __init__(self):
        self.keys = []

    def _record(self, name, data):
        data = np.asarray(data)
        if not any(n == name and np.array_equal(np.asarray(
                jax.random.key_data(k)), data) for n, k in self.keys):
            self.keys.append((name, jax.random.wrap_key_data(data)))

    def wrap(self, monkeypatch, cls, name: str, key_index: int):
        orig = getattr(cls, name)

        def wrapper(mod, *args, **kwargs):
            jax.debug.callback(lambda d: self._record(name, d),
                               jax.random.key_data(args[key_index]))
            return orig(mod, *args, **kwargs)

        monkeypatch.setattr(cls, name, wrapper)


def typed_grads(module: torch.nn.Module, flax_grads) -> dict:
    """A flax gradient tree in the port's names and layouts, by the
    port's submodule types."""
    tree = jax.tree_util.tree_map(np.asarray, flax_grads)
    return flax_to_torch(tree, module=module)


def load_typed(module: torch.nn.Module, flax_params) -> None:
    tree = jax.tree_util.tree_map(np.asarray, flax_params)
    module.load_state_dict(flax_to_torch(tree, module=module), strict=True)


def assert_leaves_close(ours: dict, ref: dict, tol: float) -> float:
    """Every leaf within ``tol`` of its norm (relative L2); returns the
    worst reading."""
    assert set(ours) == set(ref), set(ours) ^ set(ref)
    worst = 0.0
    for name in ref:
        got = ours[name] if ours[name] is not None else torch.zeros_like(
            torch.as_tensor(np.asarray(ref[name])))
        err = rel_l2(got, ref[name])
        worst = max(worst, err)
        assert err <= tol, f"{name}: {err:.3g} > {tol}"
    return worst
