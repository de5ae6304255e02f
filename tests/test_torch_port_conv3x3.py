"""K1 and K2 of the PyTorch port against the JAX package's Pallas kernel
bodies themselves, K1's and K2's dispatch rules, and the tensor-core
K2's plan of splits.

``conv3x3_same`` in the JAX package takes XLA by default, so these tests
build ``pl.pallas_call`` around the unchanged ``_fwd_kernel`` and
``_wgrad_kernel`` with plain BlockSpecs (one image a grid step) and run it
in interpret mode on the CPU. The port's side is what it runs on CPU
tensors: the plain versions, through the public wrappers and
``Conv3x3Fn``. dx goes through ``flip_transpose`` on the port's side and
through the JAX backward's own flip on the JAX side. Tolerance 2e-5 max
abs in fp32 (sums of at most 576 products, reassociated).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from torch_port_util import max_abs, t32
from ode_rl_torch.ops.common import bf16_ulps
from ode_rl_torch.ops.conv3x3 import (Conv3x3Fn, conv3x3_fwd, conv3x3_wgrad,
                                      flip_transpose, uses_tensor_cores,
                                      wgrad_tc_plan, wgrad_uses_tensor_cores)
from ode_rl_tpu.ops.conv3x3 import _fwd_kernel, _wgrad_kernel

TOL = 2e-5
SHAPES = [(2, 8, 8, 64, 64), (2, 16, 16, 64, 64), (2, 5, 7, 16, 24)]


def _pallas_fwd(x, w2d):
    b, h, w, cin = x.shape
    cout = w2d.shape[1]
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    return pl.pallas_call(
        functools.partial(_fwd_kernel, tb=1, h=h, w=w, cin=cin, cout=cout),
        grid=(b,),
        in_specs=[pl.BlockSpec((1, h + 2, w + 2, cin), lambda i: (i, 0, 0, 0)),
                  pl.BlockSpec((9 * cin, cout), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, h, w, cout), lambda i: (i, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, h, w, cout), x.dtype),
        interpret=True)(xp, w2d)


def _pallas_wgrad(x, g):
    b, h, w, cin = x.shape
    cout = g.shape[3]
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    return pl.pallas_call(
        functools.partial(_wgrad_kernel, tb=1, h=h, w=w, cin=cin,
                          cout=cout),
        grid=(b,),
        in_specs=[pl.BlockSpec((1, h + 2, w + 2, cin), lambda i: (i, 0, 0, 0)),
                  pl.BlockSpec((1, h, w, cout), lambda i: (i, 0, 0, 0))],
        out_specs=pl.BlockSpec((9 * cin, cout), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((9 * cin, cout), jnp.float32),
        interpret=True)(xp, g)


def _inputs(shape, seed):
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    w2d = (rng.randn(9 * cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    g = rng.randn(b, h, w, cout).astype(np.float32)
    return x, w2d, g


@pytest.mark.parametrize("shape", SHAPES)
def test_k1_plain_matches_pallas_fwd_kernel(shape):
    x, w2d, _ = _inputs(shape, 0)
    ref = _pallas_fwd(jnp.asarray(x), jnp.asarray(w2d))
    assert max_abs(conv3x3_fwd(t32(x), t32(w2d)), ref) <= TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_k1_dx_matches_pallas_fwd_kernel_on_flipped_weights(shape):
    """dx of Conv3x3Fn (K1 on flip_transpose(w2d)) against the Pallas
    forward kernel on the weights as the JAX backward flips them."""
    x, w2d, g = _inputs(shape, 1)
    b, h, w, cin, cout = shape
    w_t = jnp.flip(jnp.asarray(w2d).reshape(3, 3, cin, cout), axis=(0, 1))
    ref = _pallas_fwd(jnp.asarray(g),
                      w_t.transpose(0, 1, 3, 2).reshape(9 * cout, cin))
    leaf = t32(x).requires_grad_(True)
    (dx,) = torch.autograd.grad(Conv3x3Fn.apply(leaf, t32(w2d)), leaf,
                                t32(g))
    assert max_abs(dx, ref) <= TOL
    assert max_abs(conv3x3_fwd(t32(g), flip_transpose(t32(w2d), cin, cout)),
                   ref) <= TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_k2_plain_matches_pallas_wgrad_kernel(shape):
    x, w2d, g = _inputs(shape, 2)
    ref = _pallas_wgrad(jnp.asarray(x), jnp.asarray(g))
    assert max_abs(conv3x3_wgrad(t32(x), t32(g)), ref) <= TOL
    leaf = t32(w2d).requires_grad_(True)
    (dw,) = torch.autograd.grad(Conv3x3Fn.apply(t32(x), leaf), leaf, t32(g))
    assert max_abs(dw, ref) <= TOL


# (dtype, Cin, Cout, W, takes the tensor cores): the flagship forward and
# dx, narrow and wide channels that fit, then what stays on SIMT: weights
# and halos beyond a block's shared memory (width-dependent: a 32-wide
# tile's halo does not fit beside 144 KB of weights), fp32, ragged
# channels, Cout above wgmma's 256.
RULE_CASES = [
    (torch.bfloat16, 64, 64, 16, True),
    (torch.bfloat16, 16, 32, 7, True),
    (torch.bfloat16, 64, 128, 16, True),
    (torch.bfloat16, 128, 64, 8, True),
    (torch.bfloat16, 64, 128, 33, False),
    (torch.bfloat16, 128, 128, 16, False),
    (torch.float32, 64, 64, 16, False),
    (torch.bfloat16, 3, 64, 16, False),
    (torch.bfloat16, 8, 64, 16, False),
    (torch.bfloat16, 64, 5, 16, False),
    (torch.bfloat16, 64, 24, 16, False),
    (torch.bfloat16, 16, 272, 16, False),
]


@pytest.mark.parametrize("dtype,cin,cout,w,expected", RULE_CASES)
def test_k1_dispatch_rule(dtype, cin, cout, w, expected):
    assert uses_tensor_cores(dtype, cin, cout, w) is expected


def test_bf16_ulps_tells_rounding_from_truncation():
    """The card tests' bf16 check: exact rounding reads 0, a result one
    ulp up reads 1 ulp on every output, truncation about half the outputs
    one ulp off."""
    ref = torch.from_numpy(np.random.RandomState(3).randn(4096))
    assert bf16_ulps(ref.to(torch.bfloat16), ref) == (0.0, 0.0)
    up = torch.nextafter(ref.to(torch.bfloat16),
                         torch.full_like(ref, np.inf).to(torch.bfloat16))
    ulps, share = bf16_ulps(up, ref)
    assert ulps == 1.0 and share == 1.0
    truncated = (ref.float().view(torch.int32) & ~0xFFFF).view(torch.float32)
    ulps, share = bf16_ulps(truncated.to(torch.bfloat16), ref)
    assert ulps <= 1.0 and 0.4 < share < 0.6


# (dtype, Cin, Cout, W, takes the tensor cores): the flagship's 64 -> 64,
# wider channels and several channel pairs, maps 1 to 33 wide (tiles 8, 16,
# 32), then what stays on SIMT: a plan that does not fit (36 channel
# pairs need 108 resident blocks beside their splits), fp32, narrow
# channels, ragged channels.
K2_RULE_CASES = [
    (torch.bfloat16, 64, 64, 16, True),
    (torch.bfloat16, 64, 128, 16, True),
    (torch.bfloat16, 128, 64, 7, True),
    (torch.bfloat16, 64, 64, 33, True),
    (torch.bfloat16, 64, 64, 1, True),
    (torch.bfloat16, 256, 256, 16, True),
    (torch.bfloat16, 384, 384, 16, False),
    (torch.float32, 64, 64, 16, False),
    (torch.bfloat16, 32, 64, 16, False),
    (torch.bfloat16, 16, 16, 16, False),
    (torch.bfloat16, 64, 96, 16, False),
    (torch.bfloat16, 3, 64, 16, False),
    (torch.bfloat16, 64, 5, 16, False),
]


@pytest.mark.parametrize("dtype,cin,cout,w,expected", K2_RULE_CASES)
def test_k2_dispatch_rule(dtype, cin, cout, w, expected):
    assert wgrad_uses_tensor_cores(dtype, cin, cout, w) is expected


# (B, H, W, Cin, Cout, SMs): the flagship on an H100 SXM and PCIe, the
# card tests' shapes, one tile in all, and a cap above the tile count.
K2_PLAN_CASES = [(128, 16, 16, 64, 64, 132), (128, 16, 16, 64, 64, 114),
                 (1, 16, 16, 64, 64, 132), (3, 5, 7, 64, 64, 132),
                 (2, 9, 11, 64, 128, 132), (2, 20, 33, 64, 64, 132),
                 (2, 12, 7, 128, 64, 132), (1, 3, 3, 64, 64, 132),
                 (64, 40, 40, 256, 256, 132)]


def _tile_pixels(tile, b, h, w, tw):
    """The image pixels of a tensor-core K2 tile (8 rows by TW, clipped)."""
    tiles_x = -(-w // tw)
    per_img = tiles_x * -(-h // 8)
    img, r = divmod(tile, per_img)
    y0, x0 = (r // tiles_x) * 8, (r % tiles_x) * tw
    return {(img, y, x) for y in range(y0, min(y0 + 8, h))
            for x in range(x0, min(x0 + tw, w))}


@pytest.mark.parametrize("b,h,w,cin,cout,sms", K2_PLAN_CASES)
def test_k2_plan_covers_every_pixel_once(b, h, w, cin, cout, sms):
    """The splits' runs of tiles partition the tiles, none is empty, the
    blocks fit on the card, and the tiles cover every pixel once."""
    tw, splits, per = wgrad_tc_plan(b, h, w, cin, cout, sms)
    tiles = b * -(-h // 8) * -(-w // tw)
    runs = [range(s * per, min((s + 1) * per, tiles)) for s in range(splits)]
    assert all(len(r) > 0 for r in runs)
    assert [t for r in runs for t in r] == list(range(tiles))
    assert 3 * (cin // 64) * (cout // 64) * splits <= sms
    seen = [p for t in range(tiles) for p in _tile_pixels(t, b, h, w, tw)]
    assert len(seen) == len(set(seen)) == b * h * w
