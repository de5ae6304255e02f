"""The 'model' and 'space' axes of the port's parallel/, in one process:
ranks as threads of this process (test_torch_port_parallel.py's
ThreadGroup), one group a line of each axis of a 2-D grid.

* K1/K2 with halo operands (``space_conv3x3``) on 'space' lines of 2
  and 4 against JAX's whole-map conv and its VJP, and a spy on the
  kernels' calls under ``Conv3x3``: a rank's own rows and a halo only.
* Height-sharded layers (parallel/sp.py) on a 1 x 2 ('data', 'space')
  grid against the unsharded layer, forward and every gradient: the
  3x3 stride-2 padding-1 conv of the encoders, K1's 3x3 SAME
  (``Conv3x3``), the ConvGRU's 5x5 SAME, the heads' 1x1 and the
  decoders' 4x4 stride-2 transposed conv. Each rank takes its rows of
  the input and of the output's cotangent; the outputs and input
  gradients are its rows of the unsharded ones, and the parameter
  gradients summed over the ranks the unsharded ones.
* Column-parallel layers (parallel/tp.py) on a 1 x 2 ('data', 'model')
  grid: K1's conv, 1x1, 5x5, the stride-2 3x3 and the transposed conv.
  Each rank holds its Cout slice of the weights and the whole input and
  output; the output, the input's gradient and the bias's are the
  unsharded ones on both ranks, the weight's gradient its slice; in bf16
  K1's dx is the JAX VJP's fp32 sum rounded once.
* The moments-in K3/K4 plain versions under 'space' against JAX's
  ``_groupnorm_f32`` formula over the whole height, with gradients.
* ``grad_norm`` with sharded and replicated leaves; the TP rule names
  JAX's 11 flagship leaves; ``shard_batch_sp``'s layout mirrors
  tests/test_mesh.py::test_sp_mesh_axes_and_layout.

Tolerance: fp32 1e-5 max abs, in units of the reference's largest
magnitude where that is above 1 (sums over the cut in another order); the
GroupNorm gradients 1e-5 relative L2.
"""

import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_parallel import ThreadGroup, rel
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.nn.conv_stacks import Conv, Conv3x3, ConvTranspose
from ode_rl_torch.ops.gru_gates import fused_gru_blend, fused_gru_gates
from ode_rl_torch.parallel import (MODEL_AXIS, SPACE_AXIS, Mesh,
                                   gather_pytree, shard_batch_sp,
                                   shard_params_tp, tp_param_spec)
from ode_rl_torch.nn import conv_stacks
from ode_rl_torch.parallel import sp
from ode_rl_torch.parallel.sp import conv_halo, space_conv3x3, transposed_halo
from ode_rl_torch.train.step import global_norm, grad_norm

TOL = 1e-5


class ThreadGrid(Mesh):
    """A (n_data, n) grid of thread ranks: every rank, each 'data' line
    and each line of the second axis exchange through a group of its
    own."""

    def __init__(self, groups: dict, rank: int, axis: str, n_data: int,
                 n: int):
        super().__init__(rank, n_data * n, torch.device("cpu"), "threads",
                         {"data": n_data, axis: n})
        self.lines = groups
        self.second = axis

    def _line(self, axis):
        span = self._span(axis)
        if span is None:
            return self.lines["all"], self.rank
        if span == "data":
            return (self.lines["data"][self.index(self.second)],
                    self.index("data"))
        return self.lines["inner"][self.index("data")], self.index(span)

    def all_reduce_(self, t, axis=None):
        if self._trivial(axis):
            return t
        group, r = self._line(axis)
        parts = group.exchange(r, t)
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        return t.copy_(total)

    def all_gather(self, t, dim=0, axis=None):
        if self._trivial(axis):
            return t
        group, r = self._line(axis)
        return torch.cat(group.exchange(r, t), dim=dim)

    def broadcast_(self, t, src=0):
        return t.copy_(self.lines["all"].exchange(self.rank, t)[src])


def on_grid(fn, axis: str, n_data: int = 1, n: int = 2) -> list:
    """``fn(mesh)`` on the ranks of an (n_data, n) grid of threads, each
    inside its mesh; their results in rank order."""
    world = n_data * n
    groups = {"all": ThreadGroup(world),
              "data": [ThreadGroup(n_data) for _ in range(n)],
              "inner": [ThreadGroup(n) for _ in range(n_data)]}
    out, errors = [None] * world, []

    def body(rank):
        try:
            with ThreadGrid(groups, rank, axis, n_data, n) as mesh:
                out[rank] = fn(mesh)
        except BaseException as e:   # noqa: BLE001 - re-raised below
            errors.append(e)
            for g in [groups["all"], *groups["data"], *groups["inner"]]:
                g.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    return out


def max_abs(a, b) -> float:
    """Max abs difference, in units of the reference's largest magnitude
    where it is above 1 (a parameter gradient sums many products)."""
    scale = max(1.0, float(b.double().abs().max()))
    return float((a.double() - b.double()).abs().max()) / scale


def _gen(seed):
    return torch.Generator().manual_seed(seed)


LAYERS = {
    "conv3x3_stride2": lambda g: Conv(6, 8, 3, stride=2, padding=1,
                                      generator=g),
    "k1_conv3x3": lambda g: Conv3x3(6, 8, generator=g),
    "conv5x5": lambda g: Conv(6, 8, 5, padding=2, generator=g),
    "conv1x1": lambda g: Conv(6, 8, 1, generator=g),
    "transposed4x4": lambda g: ConvTranspose(6, 8, generator=g),
}


def _layer(name):
    layer = LAYERS[name](_gen(1))
    with torch.no_grad():
        for p in layer.parameters():   # nonzero biases
            if p.ndim == 1:
                p.copy_(torch.randn(p.shape, generator=_gen(2)))
    return layer


def _unsharded(layer, x, gy):
    x = x.clone().requires_grad_(True)
    y = layer(x)
    (y * gy).sum().backward()
    grads = {n: p.grad.clone() for n, p in layer.named_parameters()}
    layer.zero_grad(set_to_none=True)
    return y.detach(), x.grad, grads


def test_halos_of_each_layer():
    assert conv_halo(3, 2, 1) == (1, 0)
    assert conv_halo(3, 1, 1) == (1, 1)
    assert conv_halo(5, 1, 2) == (2, 2)
    assert conv_halo(1, 1, 0) == (0, 0)
    assert transposed_halo(4, 2, 1) == (1, 1, 3)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_height_sharded_layer_matches_unsharded(name):
    layer = _layer(name)
    x = torch.randn((2, 16, 12, 6), generator=_gen(3))
    y_ref, dx_ref, grads_ref = _unsharded(layer, x, torch.ones(1))
    gy = torch.randn(y_ref.shape, generator=_gen(4))
    y_ref, dx_ref, grads_ref = _unsharded(layer, x, gy)

    def rank(mesh):
        mine = copy.deepcopy(layer)
        s = mesh.index(SPACE_AXIS)
        rows = lambda t: t.chunk(2, dim=1)[s]
        xs = rows(x).clone().requires_grad_(True)
        y = mine(xs)
        (y * rows(gy)).sum().backward()
        return (y.detach(), xs.grad,
                {n: p.grad for n, p in mine.named_parameters()})

    out = on_grid(rank, SPACE_AXIS)
    assert max_abs(torch.cat([o[0] for o in out], 1), y_ref) < TOL
    assert max_abs(torch.cat([o[1] for o in out], 1), dx_ref) < TOL
    for n, g in grads_ref.items():
        assert max_abs(out[0][2][n] + out[1][2][n], g) < TOL, n


@pytest.mark.parametrize("n", [2, 4])
def test_space_conv3x3_matches_jax_whole_map(n):
    """K1/K2 with halo operands (``space_conv3x3``) on a 'space' line of
    ``n`` thread ranks against JAX's ``conv3x3_same`` over the whole map
    and its VJP: each rank's rows of the output and of dx, and dW summed
    over the ranks. fp32, 1e-5 max abs in units of the reference's
    largest magnitude where that is above 1."""
    from ode_rl_tpu.ops.conv3x3 import conv3x3_same as jax_conv3x3
    rng = np.random.RandomState(8)
    x = rng.randn(2, 16, 8, 16).astype(np.float32)
    kernel = (rng.randn(3, 3, 16, 16) / 12).astype(np.float32)
    gy = rng.randn(2, 16, 8, 16).astype(np.float32)
    y_ref, vjp = jax.vjp(jax_conv3x3, jnp.asarray(x), jnp.asarray(kernel))
    dx_ref, dk_ref = (torch.from_numpy(np.array(t))
                      for t in vjp(jnp.asarray(gy)))
    y_ref = torch.from_numpy(np.array(y_ref))

    def rank(mesh):
        rows = lambda t: torch.from_numpy(t).chunk(n, dim=1)[
            mesh.index(SPACE_AXIS)].clone()
        xs = rows(x).requires_grad_(True)
        w2d = torch.from_numpy(kernel).reshape(144, 16).requires_grad_(True)
        y = space_conv3x3(xs, w2d, mesh)
        y.backward(rows(gy))
        return y.detach(), xs.grad, w2d.grad

    out = on_grid(rank, SPACE_AXIS, n=n)
    assert max_abs(torch.cat([o[0] for o in out], 1), y_ref) < TOL
    assert max_abs(torch.cat([o[1] for o in out], 1), dx_ref) < TOL
    assert max_abs(sum(o[2] for o in out).reshape(3, 3, 16, 16),
                   dk_ref) < TOL


def test_space_k1_k2_take_own_rows_and_a_halo(monkeypatch):
    """Under a 'space' line of 2, ``Conv3x3`` calls K1 (forward and dx)
    and K2 only with the rank's own 8 of 16 rows and a (B, 2, W, C) halo,
    never with the 10-row tile, and nothing else reaches the kernels."""
    calls, lock = [], threading.Lock()

    def spy(fn, name):
        def call(x, *args, halo=None, **kw):
            with lock:
                calls.append((name, tuple(x.shape),
                              None if halo is None else tuple(halo.shape)))
            return fn(x, *args, halo=halo, **kw)
        return call

    def refuse(*args, **kw):
        raise AssertionError("a K1/K2 call outside space_conv3x3")

    monkeypatch.setattr(sp, "conv3x3_fwd", spy(sp.conv3x3_fwd, "K1"))
    monkeypatch.setattr(sp, "conv3x3_wgrad", spy(sp.conv3x3_wgrad, "K2"))
    monkeypatch.setattr(conv_stacks, "conv3x3_same", refuse)
    monkeypatch.setattr(conv_stacks, "column_conv3x3", refuse)
    layer = _layer("k1_conv3x3")
    x = torch.randn((2, 16, 12, 6), generator=_gen(3))

    def rank(mesh):
        xs = x.chunk(2, dim=1)[mesh.index(SPACE_AXIS)].clone()
        xs.requires_grad_(True)
        copy.deepcopy(layer)(xs).sum().backward()

    on_grid(rank, SPACE_AXIS)
    assert sorted(calls) == sorted(2 * [
        ("K1", (2, 8, 12, 6), (2, 2, 12, 6)),
        ("K1", (2, 8, 12, 8), (2, 2, 12, 8)),
        ("K2", (2, 8, 12, 6), (2, 2, 12, 6))])


TP_LAYERS = ("k1_conv3x3", "conv1x1", "conv5x5", "conv3x3_stride2",
             "transposed4x4")


@pytest.mark.parametrize("name", TP_LAYERS)
def test_column_parallel_layer_matches_unsharded(name):
    layer = _layer(name)
    x = torch.randn((2, 8, 8, 6), generator=_gen(3))
    y_ref, _, _ = _unsharded(layer, x, torch.ones(1))
    gy = torch.randn(y_ref.shape, generator=_gen(4))
    y_ref, dx_ref, grads_ref = _unsharded(layer, x, gy)

    def rank(mesh):
        mine = shard_params_tp(copy.deepcopy(layer), mesh, min_channels=8)
        xs = x.clone().requires_grad_(True)
        y = mine(xs)
        (y * gy).sum().backward()
        dims = {n: getattr(p, "tp_dim", None)
                for n, p in mine.named_parameters()}
        return (y.detach(), xs.grad, dims,
                {n: p.grad for n, p in mine.named_parameters()},
                gather_pytree(mine, mesh))

    out = on_grid(rank, MODEL_AXIS)
    full = dict(layer.state_dict())
    for m, (y, dx, dims, grads, gathered) in enumerate(out):
        assert max_abs(y, y_ref) < TOL
        assert max_abs(dx, dx_ref) < TOL
        weight = "kernel" if name == "k1_conv3x3" else "weight"
        assert dims == {weight: 1 if name == "transposed4x4" else (
            3 if name == "k1_conv3x3" else 0), "bias": None}
        for n, g in grads_ref.items():
            want = (g if dims[n] is None
                    else g.chunk(2, dim=dims[n])[m])
            assert max_abs(grads[n], want) < TOL, n
        for n, t in full.items():
            assert torch.equal(gathered[n], t), n


def test_column_parallel_k1_bf16_dx_is_rounded_once_as_jax():
    """A bf16 Conv3x3 on a 'model' line of 2: each rank's dx partial is K1
    with an fp32 output on its Cout slice, summed over the line in fp32
    and rounded once, as JAX's unsharded VJP (K1 on the flipped weights,
    fp32 sums cast once) rounds it: within one bf16 ulp of jax.vjp of the
    conv in fp32 on the same bf16 values, at most 2e-3 of the entries one
    ulp off (the card's K1 limit), and bit-equal across the ranks."""
    from ode_rl_torch.ops.common import bf16_ulps
    from ode_rl_tpu.ops.conv3x3 import _xla_conv
    layer = Conv3x3(16, 32, dtype=torch.bfloat16, generator=_gen(5))
    x = torch.randn((2, 8, 8, 16), generator=_gen(6)).bfloat16()
    gy = torch.randn((2, 8, 8, 32), generator=_gen(7)).bfloat16()

    def rank(mesh):
        mine = shard_params_tp(copy.deepcopy(layer), mesh, min_channels=8)
        xs = x.clone().requires_grad_(True)
        (dx,) = torch.autograd.grad(mine(xs), xs, gy)
        return dx

    out = on_grid(rank, MODEL_AXIS)
    kernel = jnp.asarray(layer.kernel.detach().bfloat16().float().numpy())
    _, vjp = jax.vjp(lambda v: _xla_conv(v, kernel),
                     jnp.asarray(x.float().numpy()))
    (ref,) = vjp(jnp.asarray(gy.float().numpy()))
    ref = torch.from_numpy(np.array(ref)).double()
    assert out[0].dtype == torch.bfloat16 and torch.equal(out[0], out[1])
    ulps, share = bf16_ulps(out[0], ref)
    assert ulps <= 1.0 and share <= 2e-3


# -- K3/K4 moments over the cut ------------------------------------------

def _jax_gn(x, scale, bias, groups):
    from ode_rl_tpu.ops.gru_gates import _groupnorm_f32
    return jax.vmap(lambda xi: _groupnorm_f32(xi, scale, bias, groups))(x)


def _jax_gates(g, h, scale, bias, groups):
    z, r = jnp.split(jax.nn.sigmoid(_jax_gn(g, scale, bias, groups)), 2,
                     axis=-1)
    return z, r * h


def _jax_blend(c, z, h, scale, bias, groups):
    cand = jnp.tanh(_jax_gn(c, scale, bias, groups))
    return (1.0 - z) * h + z * cand


@pytest.mark.parametrize("which", ["gates", "blend"])
def test_gru_tails_take_moments_over_the_cut(which):
    rng = np.random.RandomState(5)
    b, hh, w, c, groups = 2, 8, 6, 8, 2
    n_in = 2 * c if which == "gates" else c
    groups = 4 if which == "gates" else groups
    x = rng.randn(b, hh, w, n_in).astype(np.float32) * 2 + 0.5
    z = (1 / (1 + np.exp(-rng.randn(b, hh, w, c)))).astype(np.float32)
    h = np.tanh(rng.randn(b, hh, w, c)).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(n_in)).astype(np.float32)
    bias = (0.1 * rng.randn(n_in)).astype(np.float32)
    if which == "gates":
        outs, vjp = jax.vjp(lambda *a: _jax_gates(*a, groups), x, h, scale,
                            bias)
    else:
        outs, vjp = jax.vjp(lambda *a: _jax_blend(*a, groups), x, z, h,
                            scale, bias)
        outs = (outs,)
    cts = tuple(rng.randn(*o.shape).astype(np.float32) for o in outs)
    ref_grads = vjp(cts if which == "gates" else cts[0])
    inputs = (x, h, scale, bias) if which == "gates" else (
        x, z, h, scale, bias)
    fn = fused_gru_gates if which == "gates" else fused_gru_blend

    def rank(mesh):
        s = mesh.index(SPACE_AXIS)
        rows = lambda a: torch.from_numpy(a).chunk(2, dim=1)[s]
        leaves = [(rows(a) if a.ndim == 4 else torch.from_numpy(a))
                  .clone().requires_grad_(True) for a in inputs]
        got = fn(*leaves, groups)
        got = got if isinstance(got, tuple) else (got,)
        torch.autograd.backward(got, [rows(ct) for ct in cts])
        return [o.detach() for o in got], [t.grad for t in leaves]

    out = on_grid(rank, SPACE_AXIS)
    for k, ref in enumerate(outs):
        got = torch.cat([o[0][k] for o in out], dim=1)
        assert max_abs(got, torch.from_numpy(np.array(ref))) < TOL
    for k, ref in enumerate(ref_grads):
        ref = torch.from_numpy(np.array(ref))
        got = (torch.cat([o[1][k] for o in out], dim=1) if ref.ndim == 4
               else out[0][1][k] + out[1][1][k])
        assert rel(got, ref) < TOL, k


# -- the step's norm, the TP rule, the SP batch ----------------------------

def test_grad_norm_sums_sharded_leaves_over_model():
    gen = _gen(7)
    full = {"w": torch.randn(4, 6, generator=gen),
            "b": torch.randn(6, generator=gen)}
    want = global_norm(full.values())

    def rank(mesh):
        m = mesh.index(MODEL_AXIS)
        w = torch.nn.Parameter(torch.zeros(4, 3))
        w.grad = full["w"].chunk(2, dim=1)[m].clone()
        w.tp_dim = 1
        b = torch.nn.Parameter(torch.zeros(6))
        b.grad = full["b"].clone()
        return grad_norm([w, b], mesh)

    out = on_grid(rank, MODEL_AXIS)
    for got in out:
        assert abs(float(got) - float(want)) < 1e-6 * float(want)
    assert float(out[0]) > float(global_norm([full["b"]])) + 1e-3


class _StandIn:
    shape = {"model": 2}


def _torch_name(path) -> str:
    keys = [getattr(k, "key", str(k)) for k in path]
    field = keys[-2] in ("in", "out") or keys[-2].startswith("mid_")
    if keys[-1] == "kernel" and not field and len(keys) >= 2:
        keys[-1] = "weight"
    return ".".join(keys)


def test_tp_rule_names_jax_flagship_leaves():
    from ode_rl_tpu.models.odeconvgru import ODEConvGRUModel as JaxModel
    from ode_rl_tpu.parallel.tp import tp_param_spec as jax_spec
    from ode_rl_torch.models.odeconvgru import ODEConvGRUModel
    kw = dict(in_channels=1, conv_encoder_out_ch=64,
              neural_ode_decoder_out_ch=64, neural_ode_n_units=64,
              n_ode_layers=1, ode_max_steps=32)
    from ode_rl_tpu.core.config import Config as JaxConfig
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    from ode_rl_tpu.train.step import create_train_state
    params = create_train_state(
        JaxModel(**kw), JaxConfig({"lr": 1e-3, "clip": -1}),
        jax_batch(jnp.zeros((1, 2, 64, 64, 1)), n_in=1),
        jax.random.key(0)).params
    specs = jax.tree_util.tree_flatten_with_path(
        jax_spec(params, _StandIn()),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    jax_names = {_torch_name(path) for path, spec in specs
                 if "model" in tuple(spec)}
    port = tp_param_spec(ODEConvGRUModel(**kw, generator=_gen(0)),
                         _StandIn())
    port_names = {n for n, spec in port.items() if "model" in spec}
    assert len(jax_names) == 11
    assert port_names == jax_names


def test_shard_batch_sp_layout():
    video = torch.rand((8, 4, 64, 64, 1)) - 0.5
    batch = make_batch_dict(video, n_in=2)
    for rank in range(8):
        mesh = Mesh(rank, 8, axes={"data": 4, "space": 2})
        d, s = rank // 2, rank % 2
        rows = shard_batch_sp(batch, mesh)
        assert set(rows) == set(batch)
        assert torch.equal(rows["observed_data"],
                           batch["observed_data"][2 * d:2 * d + 2, :,
                                                  32 * s:32 * s + 32])
        # Per-sample vectors shard over 'data' only; timestamps stay
        # whole.
        assert torch.equal(rows["observed_mask"],
                           batch["observed_mask"][2 * d:2 * d + 2])
        assert rows["observed_tp"] is batch["observed_tp"]
