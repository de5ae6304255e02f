"""Kernels K1-K4 of the PyTorch port: their plain versions (what the port
runs on CPU tensors) against the JAX package's ops, the dispatch rule, the
build's failure path, and the port's independence from JAX.

The same numpy inputs go to both sides. The JAX gates/blend ops run both
through XLA (``impl="xla"``) and through the Pallas kernels in interpret
mode (``impl="interpret"``). Tolerance for single ops: 2e-5 max abs (fp32
sums reassociated between XLA:CPU and torch).
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import max_abs, t32
from ode_rl_torch.ops import _build, common
from ode_rl_torch.ops.conv3x3 import conv3x3_fwd, conv3x3_same
from ode_rl_torch.ops.gru_gates import fused_gru_blend, fused_gru_gates

TOL = 2e-5
REPO = pathlib.Path(__file__).resolve().parents[1]


def _cotangents(shapes):
    rng = np.random.RandomState(99)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _grads_torch(fn, arrays):
    leaves = [t32(a).requires_grad_(True) for a in arrays]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    weights = [t32(w) for w in _cotangents([o.shape for o in outs])]
    sum(torch.sum(o * w) for o, w in zip(outs, weights)).backward()
    return outs, [leaf.grad for leaf in leaves]


def _grads_jax(fn, arrays):
    outs = fn(*arrays)
    outs = outs if isinstance(outs, tuple) else (outs,)
    weights = _cotangents([o.shape for o in outs])

    def loss(*a):
        o = fn(*a)
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(x * w) for x, w in zip(o, weights))

    return outs, jax.grad(loss, argnums=tuple(range(len(arrays))))(*arrays)


def _assert_same(torch_side, jax_side):
    (t_outs, t_grads), (j_outs, j_grads) = torch_side, jax_side
    for a, b in zip(t_outs, j_outs):
        assert max_abs(a, b) <= TOL
    for a, b in zip(t_grads, j_grads):
        assert max_abs(a, b) <= TOL


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 8, 8, 64, 64),
                                            (2, 5, 7, 16, 24)])
def test_conv3x3_matches_jax_forward_dx_dw(b, h, w, cin, cout):
    """Forward, dx (K1 on flipped weights) and dw (K2), plain versions,
    against ``conv3x3_same`` and ``jax.grad`` of it."""
    from ode_rl_tpu.ops.conv3x3 import conv3x3_same as jax_conv

    rng = np.random.RandomState(0)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    bias = (0.1 * rng.randn(cout)).astype(np.float32)
    _assert_same(_grads_torch(conv3x3_same, [x, k, bias]),
                 _grads_jax(jax_conv, [jnp.asarray(a) for a in (x, k, bias)]))


def _gates_inputs(rng, c=64):
    return [rng.randn(2, 8, 8, 2 * c).astype(np.float32),
            rng.randn(2, 8, 8, c).astype(np.float32),
            rng.uniform(0.5, 1.5, 2 * c).astype(np.float32),
            (0.1 * rng.randn(2 * c)).astype(np.float32)]


@pytest.mark.parametrize("impl", ["xla", "interpret"])
def test_fused_gru_gates_matches_jax(impl):
    """K3's plain version, 4 groups over 2C = 128 (groups 0-1 feed z,
    2-3 feed r*h), forward and gradients."""
    from ode_rl_tpu.ops.gru_gates import fused_gru_gates as jax_gates

    arrays = _gates_inputs(np.random.RandomState(1))
    _assert_same(
        _grads_torch(lambda *a: fused_gru_gates(*a, 4), arrays),
        _grads_jax(lambda *a: jax_gates(*a, 4, impl=impl),
                   [jnp.asarray(a) for a in arrays]))


@pytest.mark.parametrize("impl", ["xla", "interpret"])
def test_fused_gru_blend_matches_jax(impl):
    """K4's plain version, 2 groups over C = 64, forward and gradients."""
    from ode_rl_tpu.ops.gru_gates import fused_gru_blend as jax_blend

    rng = np.random.RandomState(2)
    c = 64
    arrays = [rng.randn(2, 8, 8, c).astype(np.float32),
              (1 / (1 + np.exp(-rng.randn(2, 8, 8, c)))).astype(np.float32),
              np.tanh(rng.randn(2, 8, 8, c)).astype(np.float32),
              rng.uniform(0.5, 1.5, c).astype(np.float32),
              (0.1 * rng.randn(c)).astype(np.float32)]
    _assert_same(
        _grads_torch(lambda *a: fused_gru_blend(*a, 2), arrays),
        _grads_jax(lambda *a: jax_blend(*a, 2, impl=impl),
                   [jnp.asarray(a) for a in arrays]))


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    common.reset_launches()
    rng = np.random.RandomState(3)
    x = t32(rng.randn(1, 4, 4, 8))
    out = conv3x3_fwd(x, t32(rng.randn(72, 8)))
    z, rh = fused_gru_gates(*[t32(a) for a in _gates_inputs(rng, 8)], 2)
    fused_gru_blend(rh, z, rh, t32(np.ones(8)), t32(np.zeros(8)), 2)
    assert out.shape == (1, 4, 4, 8)
    assert all(n == 0 for n in common.launches.values())


def test_other_devices_raise():
    with pytest.raises(ValueError, match="no kernel"):
        conv3x3_fwd(torch.zeros(1, 4, 4, 8, device="meta"),
                    torch.zeros(72, 8, device="meta"))


@pytest.mark.parametrize("call", ["conv_weights", "gates_channels",
                                  "gates_groups", "blend_shapes"])
def test_shape_mismatches_raise(call):
    x = torch.zeros(1, 4, 4, 8)
    calls = {
        "conv_weights": lambda: conv3x3_fwd(x, torch.zeros(64, 8)),
        "gates_channels": lambda: fused_gru_gates(
            torch.zeros(1, 4, 4, 8), x, torch.ones(8), torch.zeros(8), 2),
        "gates_groups": lambda: fused_gru_gates(
            torch.zeros(1, 4, 4, 16), x, torch.ones(16), torch.zeros(16), 3),
        "blend_shapes": lambda: fused_gru_blend(
            torch.zeros(1, 4, 4, 4), x, x, torch.ones(8), torch.zeros(8), 2),
    }
    with pytest.raises(ValueError):
        calls[call]()


def test_force_plain_is_scoped():
    assert not common._plain_forced
    with pytest.raises(RuntimeError):
        with common.force_plain():
            assert common._plain_forced
            raise RuntimeError
    assert not common._plain_forced


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_failed_build_raises_with_compiler_messages(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    (tmp_path / "k.cu").write_text("// two\n")
    assert _build.library_path() != first
    assert first.parent == _build.BUILD_DIR


_FORBIDDEN = {"jax", "flax", "optax", "yaml", "imageio", "msgpack"}


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO))
    for p in [*(REPO / "ode_rl_torch").rglob("*.py"),
              REPO / "chip_smoke.py"]))
def test_port_never_imports_jax_or_yaml(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in _FORBIDDEN, f"{path}: {name}"
            assert not name.startswith("ode_rl_tpu"), f"{path}: {name}"
