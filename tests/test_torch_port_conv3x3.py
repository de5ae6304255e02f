"""K1 and K2 of the PyTorch port against the JAX package's Pallas kernel
bodies themselves, K1's and K2's dispatch rules (K1 with an fp32 output
from bf16 too, its shared memory against csrc's plan, its column blocks
of 64, 32 or 16 output channels and every call the rule sent to the
tensor cores before NT 32 still sent there, and its plain version against
the fp64 conv; K2 in blocks of 64 or 32 output channels), the tensor-core K2's plan of splits, the SIMT K1's and K2's
plans, and the SIMT kernels' order of summation emulated in plain torch
against the Pallas kernel bodies.

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
import torch.nn.functional as F
from jax.experimental import pallas as pl

from torch_port_util import max_abs, t32
from ode_rl_torch.ops.common import bf16_ulps
from ode_rl_torch.ops.conv3x3 import (Conv3x3Fn, _tc_smem_bytes,
                                      conv3x3_fwd, conv3x3_fwd_plain,
                                      conv3x3_wgrad, flip_transpose,
                                      simt_plan, simt_slab,
                                      simt_smem_bytes, simt_split, tc_nt,
                                      uses_tensor_cores,
                                      wgrad_simt_plan,
                                      wgrad_simt_smem_bytes,
                                      wgrad_simt_tile,
                                      wgrad_tc_nt, wgrad_tc_plan,
                                      wgrad_uses_tensor_cores)
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


# (Cin, Cout, W, takes the tensor cores with bf16 in and fp32 out): a
# 'model' rank's dx partial (its Cout 32 slice of the cotangent -> 64), the
# flagship, narrow Cout (one 16-channel box of fp32), then two shapes
# whose bf16 output fits and whose doubled fp32 staging does not.
FP32_OUT_RULE_CASES = [
    (32, 64, 16, True), (64, 64, 16, True), (16, 32, 7, True),
    (32, 16, 33, True), (48, 192, 16, False), (128, 64, 8, False),
]


def _tc_plan_bytes(cin, cout, w, out_size, halo=False):
    """csrc/conv3x3.cu::tc_plan's smem_bytes, transcribed: the NT rule
    (64 where Cout % 64 == 0, else 32 where Cout % 32 == 0 and that plan
    fits 232,384 bytes, else 16), then weights in column blocks of nt, two
    halo stages of Cin / cw chunks (rows padded to 128 bytes with a halo),
    two 8 x 8 x nt staging buffers of out_size-byte elements, each 1 KB
    aligned, + 1 KB."""
    def r1k(n):
        return (n + 1023) // 1024 * 1024

    def at(nt):
        tw = 8 if w <= 8 else 16 if w <= 16 else 32
        cw = 64 if cin % 64 == 0 else (32 if cin % 32 == 0 else 16)
        pitch = (tw + 2) * cw * 2
        if halo:
            pitch = (pitch + 127) // 128 * 128
        stage = (cin // cw) * r1k(10 * pitch)
        w_bytes = (cout // nt) * r1k(9 * cin * nt * 2)
        return w_bytes + 2 * stage + 2 * r1k(64 * nt * out_size) + 1024

    nt = 64 if cout % 64 == 0 else 16
    if cout % 64 and cout % 32 == 0 and at(32) <= 232_448 - 64:
        nt = 32
    return at(nt)


@pytest.mark.parametrize("cin,cout,w,expected", FP32_OUT_RULE_CASES)
def test_k1_fp32_output_rule_and_shared_memory(cin, cout, w, expected):
    """bf16 in, fp32 out: the rule counts the doubled staging buffers
    (the Python plan mirrors tc_plan at both output sizes), fp32 in never
    takes the tensor cores, and no other output dtype is offered."""
    for out, size in ((torch.bfloat16, 2), (torch.float32, 4)):
        assert _tc_smem_bytes(cin, cout, w, out) == _tc_plan_bytes(
            cin, cout, w, size)
    assert _tc_smem_bytes(32, 64, 16, torch.float32) == 95_232
    assert uses_tensor_cores(torch.bfloat16, cin, cout, w,
                             torch.float32) is expected
    assert uses_tensor_cores(torch.bfloat16, cin, cout, w)
    assert not uses_tensor_cores(torch.float32, cin, cout, w, torch.float32)
    assert not uses_tensor_cores(torch.bfloat16, cin, cout, w, torch.float16)


@pytest.mark.parametrize("cout,nt", [(64, 64), (128, 64), (32, 32), (96, 32),
                                     (160, 32), (16, 16), (48, 16), (80, 16)])
def test_k1_output_block_width(cout, nt):
    """K1's column blocks: 64 channels where Cout % 64 == 0, 32 where Cout %
    32 == 0 (a 'model' rank's Cout 32 in one block), else 16; in bf16 and
    fp32 out, with and without a halo, at a width where all fit."""
    for out in (torch.bfloat16, torch.float32):
        for halo in (False, True):
            assert tc_nt(cout, 32, 16, out, halo) == nt
            assert uses_tensor_cores(torch.bfloat16, 32, cout, 16, out)


@pytest.mark.parametrize("halo", [False, True])
def test_k1_keeps_nt16_where_nt32_does_not_fit(halo):
    """The one plan over Cin 16-256, Cout 32-224 and W 8-33 where NT 32's
    shared memory would not fit a block and NT 16's does (Cin 160 -> 32,
    W 16, fp32 out: the doubled staging buffers): the rule keeps NT 16, so
    the call stays on the tensor cores."""
    out = torch.float32
    assert _tc_smem_bytes(160, 32, 16, out, 32, halo) > 232_448 - 64
    assert _tc_smem_bytes(160, 32, 16, out, 16, halo) <= 232_448 - 64
    assert tc_nt(32, 160, 16, out, halo) == 16
    assert tc_nt(32, 160, 16, torch.bfloat16, halo) == 32
    assert uses_tensor_cores(torch.bfloat16, 160, 32, 16, out)


def _pr22_rule(cin, cout, w, out_size):
    """The tensor-core K1's rule before NT 32, frozen: bf16 in, Cin % 16 ==
    0, Cout % 16 == 0, Cout <= 256, and the plan of column blocks of 64
    (Cout % 64 == 0) or 16 channels within 232,384 bytes."""
    def r1k(n):
        return (n + 1023) // 1024 * 1024
    if cin % 16 or cout % 16 or cout > 256:
        return False
    tw = 8 if w <= 8 else 16 if w <= 16 else 32
    cw = 64 if cin % 64 == 0 else (32 if cin % 32 == 0 else 16)
    nt = 64 if cout % 64 == 0 else 16
    stage = (cin // cw) * r1k(10 * (tw + 2) * cw * 2)
    w_bytes = (cout // nt) * r1k(9 * cin * nt * 2)
    return (w_bytes + 2 * stage + 2 * r1k(64 * nt * out_size) + 1024
            <= 232_448 - 64)


@pytest.mark.parametrize("out,size", [(torch.bfloat16, 2),
                                      (torch.float32, 4)])
@pytest.mark.parametrize("w", [8, 16, 24, 33])
def test_k1_tensor_cores_hold_wherever_they_held_before_nt32(w, out, size):
    """Over Cin 16-128 and Cout 16-256: every call the earlier rule sent to
    the tensor cores still goes there, the plan mirror equals csrc's plan
    with and without a halo, and NT 32 is taken wherever Cout % 64 != 0,
    Cout % 32 == 0 and its plan fits."""
    for cin in (16, 32, 48, 64, 128):
        for cout in range(16, 257, 16):
            now = uses_tensor_cores(torch.bfloat16, cin, cout, w, out)
            if _pr22_rule(cin, cout, w, size):
                assert now, (cin, cout, w, out)
            for halo in (False, True):
                assert _tc_smem_bytes(cin, cout, w, out, halo=halo) == (
                    _tc_plan_bytes(cin, cout, w, size, halo))
            fits32 = (_tc_smem_bytes(cin, cout, w, out, 32)
                      <= 232_448 - 64)
            want = (64 if cout % 64 == 0 else 32 if cout % 32 == 0
                    and fits32 else 16)
            assert tc_nt(cout, cin, w, out) == want


@pytest.mark.parametrize("shape", SHAPES + [(2, 16, 16, 32, 64)])
def test_k1_fp32_output_plain_matches_fp64_conv(shape):
    """The plain version of bf16 in, fp32 out: F.conv2d of the values in
    fp32, against the fp64 conv of the same bf16 values (products exact,
    sums of at most 576 rounded in fp32: 1e-5 max abs), through the
    wrapper as dx (the column-parallel dx partial's call) too; an output
    dtype other than the input's or fp32 is refused."""
    x, w2d, g = _inputs(shape, 6)
    b, h, w, cin, cout = shape
    xb, wb = t32(x).bfloat16(), t32(w2d).bfloat16()
    ref = F.conv2d(xb.double().permute(0, 3, 1, 2),
                   wb.double().reshape(3, 3, cin, cout).permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1)
    for out in (conv3x3_fwd(xb, wb, out_dtype=torch.float32),
                conv3x3_fwd_plain(xb, wb, torch.float32)):
        assert out.dtype == torch.float32
        assert max_abs(out, ref) <= 1e-5
    gb, w_t = t32(g).bfloat16(), flip_transpose(wb, cin, cout)
    dx = conv3x3_fwd(gb, w_t, out_dtype=torch.float32)
    assert dx.dtype == torch.float32
    assert max_abs(dx, conv3x3_fwd_plain(gb.double(), w_t.double())) <= 1e-5
    assert conv3x3_fwd(xb, wb, out_dtype=torch.bfloat16).dtype == \
        torch.bfloat16
    with pytest.raises(TypeError, match="output"):
        conv3x3_fwd(t32(x), t32(w2d), out_dtype=torch.bfloat16)


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
# 32), Cout 32 (a 'model' rank's slice at width 64; blocks of 32 output
# channels) at Cin 64 and 128 and Cout 96 (three blocks of 32), then what
# stays on SIMT: plans that do not fit (36 channel pairs need 108 resident
# blocks beside their splits, at NT 64 and at NT 32), fp32, narrow
# channels, ragged channels, Cout not a multiple of 32.
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
    (torch.bfloat16, 64, 96, 16, True),
    (torch.bfloat16, 3, 64, 16, False),
    (torch.bfloat16, 64, 5, 16, False),
    (torch.bfloat16, 64, 32, 16, True),
    (torch.bfloat16, 128, 32, 16, True),
    (torch.bfloat16, 64, 32, 33, True),
    (torch.bfloat16, 256, 288, 16, False),
    (torch.float32, 64, 32, 16, False),
    (torch.bfloat16, 64, 48, 16, False),
]


@pytest.mark.parametrize("dtype,cin,cout,w,expected", K2_RULE_CASES)
def test_k2_dispatch_rule(dtype, cin, cout, w, expected):
    assert wgrad_uses_tensor_cores(dtype, cin, cout, w) is expected


@pytest.mark.parametrize("cout,nt", [(64, 64), (128, 64), (32, 32),
                                     (96, 32), (160, 32)])
def test_k2_output_block_width(cout, nt):
    """Blocks of 64 output channels wherever Cout allows them (the
    flagship keeps its kernel), else of 32."""
    assert wgrad_tc_nt(cout) == nt


# (B, H, W, Cin, Cout, SMs): the flagship on an H100 SXM and PCIe, the
# card tests' shapes, one tile in all, a cap above the tile count, and at
# Cout 32 and 96 (blocks of 32 output channels) a 'model' rank's slice on
# both cards, two input blocks and ragged maps.
K2_PLAN_CASES = [(128, 16, 16, 64, 64, 132), (128, 16, 16, 64, 64, 114),
                 (1, 16, 16, 64, 64, 132), (3, 5, 7, 64, 64, 132),
                 (2, 9, 11, 64, 128, 132), (2, 20, 33, 64, 64, 132),
                 (2, 12, 7, 128, 64, 132), (1, 3, 3, 64, 64, 132),
                 (64, 40, 40, 256, 256, 132),
                 (128, 16, 16, 64, 32, 132), (128, 16, 16, 64, 32, 114),
                 (2, 9, 11, 128, 32, 132), (3, 5, 7, 64, 96, 114),
                 (2, 20, 33, 64, 32, 132)]


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
    assert 3 * (cin // 64) * (cout // wgrad_tc_nt(cout)) * splits <= sms
    seen = [p for t in range(tiles) for p in _tile_pixels(t, b, h, w, tw)]
    assert len(seen) == len(set(seen)) == b * h * w


# (dtype, B, H, W, Cin, Cout, K1 kernel, K2 kernel): the recipe's fp32
# field conv and fp32 at the flagship's and phase 5's batches take both
# SIMT kernels; the flagship's bf16 takes both tensor-core kernels; bf16
# at Cin 8 or 3, ragged channels and weights beyond a block's shared
# memory (Cin 96 -> 128 at W 20) take SIMT for whichever kernel's rule
# refuses them.
ROUTE_CASES = [
    (torch.float32, 4, 16, 16, 64, 64, "simt", "simt"),
    (torch.float32, 8, 16, 16, 64, 64, "simt", "simt"),
    (torch.float32, 128, 16, 16, 64, 64, "simt", "simt"),
    (torch.bfloat16, 128, 16, 16, 64, 64, "tc", "tc"),
    (torch.bfloat16, 4, 16, 16, 8, 64, "simt", "simt"),
    (torch.bfloat16, 2, 9, 11, 32, 64, "tc", "simt"),
    (torch.bfloat16, 2, 5, 7, 3, 16, "simt", "simt"),
    (torch.bfloat16, 1, 6, 20, 96, 128, "simt", "simt"),
]


@pytest.mark.parametrize("dtype,b,h,w,cin,cout,k1,k2", ROUTE_CASES)
def test_simt_route_and_plans(dtype, b, h, w, cin, cout, k1, k2):
    """Every K1 and K2 call outside the tensor-core rules takes the SIMT
    kernel, and every shape has a SIMT plan."""
    assert ("tc" if uses_tensor_cores(dtype, cin, cout, w) else "simt") == k1
    assert ("tc" if wgrad_uses_tensor_cores(dtype, cin, cout, w)
            else "simt") == k2
    bn, rows, blocks = simt_plan(b, h, w, cin, cout, 132)
    kt, nt, splits, per = wgrad_simt_plan(b, h, w, cin, cout, 132)
    assert bn in (16, 32) and rows >= 1 and blocks >= 1
    assert (kt, nt) in ((64, 64), (128, 64), (64, 128))
    assert splits >= 1 and per >= 16


# (B, H, W, Cin, Cout): the recipe, phase 5 and the flagship batch in
# fp32, bf16 at Cin 8, one split, a ragged 33-wide map with Cout 1, a
# ragged 96-channel slab, a single pixel, two slabs of 128 channels; the
# Vid-ODE field at its 64x64 blocks' (4, 16, 16) and mgif's and penn's
# (4, 32, 32) maps, 128 -> 64, 64 -> 128 and 64 -> 64; and S3VAE's 4x4.
SIMT_PLAN_CASES = [(4, 16, 16, 64, 64), (8, 16, 16, 64, 64),
                   (128, 16, 16, 64, 64), (4, 16, 16, 8, 64),
                   (1, 3, 5, 3, 16), (2, 17, 33, 16, 1), (1, 6, 20, 96, 128),
                   (1, 1, 1, 1, 1), (64, 40, 40, 256, 256),
                   (4, 16, 16, 128, 64), (4, 16, 16, 64, 128),
                   (4, 32, 32, 128, 64), (4, 32, 32, 64, 128),
                   (4, 32, 32, 64, 64), (4, 4, 4, 128, 64)]
_SMEM_LIMIT, _SM_SMEM = 232_448, 233_472


def _k1_blocks_per_sm(cin: int, bn: int) -> int:
    """The SIMT K1 blocks an SM holds: two, unless the shared memory of
    the first slab (and 1 KB a block) leaves room for one only."""
    return min(2, _SM_SMEM // (simt_smem_bytes(simt_slab(cin, bn), bn)
                               + 1024))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("b,h,w,cin,cout", SIMT_PLAN_CASES)
def test_simt_k1_plan_covers_every_output_once(b, h, w, cin, cout, sms):
    """Block i = ((image * strips + strip) * runs + run) * tiles + tile
    takes a 16-column strip, a run of R steps of 16 / SK rows and a tile
    of BN output channels: the runs partition each strip's rows, none
    empty, the strips every column, the tiles every channel; and the grid
    is one wave of the blocks the card holds (unless a run is a whole
    strip), more than half of it wherever there are that many (strip
    step, tile) items."""
    bn, rows, blocks = simt_plan(b, h, w, cin, cout, sms)
    sr = 16 // simt_split(simt_slab(cin, bn))
    strips, steps, tiles = -(-w // 16), -(-h // sr), -(-cout // bn)
    runs = -(-steps // rows)
    assert bn in (16, 32) and 1 <= rows <= steps
    assert blocks == b * strips * runs * tiles
    assert sorted({(i % tiles) * bn for i in range(blocks)}) == list(
        range(0, cout, bn))
    pixels = []
    for i in range(0, blocks, tiles):
        run = (i // tiles) % runs
        strip = (i // tiles // runs) % strips
        image = i // tiles // runs // strips
        y0, y1 = run * rows * sr, min((run + 1) * rows * sr, h)
        assert y1 > y0
        pixels += [(image, y, x) for y in range(y0, y1)
                   for x in range(strip * 16, min(strip * 16 + 16, w))]
    assert len(pixels) == len(set(pixels)) == b * h * w
    cap = _k1_blocks_per_sm(cin, bn) * sms
    assert blocks <= cap or rows in (1, steps)
    if b * strips * steps * tiles >= cap:
        assert 2 * blocks > cap


@pytest.mark.parametrize("cin,sk", [(1, 1), (4, 1), (5, 2), (8, 2), (12, 2),
                                    (16, 4), (28, 4), (32, 8), (60, 8), (63, 16),
                                    (64, 16), (96, 16), (1000, 16)])
def test_simt_k1_split(cin, sk):
    """SK, the groups sharing a row's products: the largest power of two
    at most the quads of the slab's first 64 channels, at most 16."""
    assert simt_split(cin) == sk


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("b,h,w,cin,cout", SIMT_PLAN_CASES)
def test_simt_k2_plan_covers_every_pixel_once(b, h, w, cin, cout, sms):
    """Split s takes pixels [s*P, (s+1)*P): whole stages of 16, none
    empty, every pixel once; with more than one split every block of the
    tiles x splits grid resident at once (two an SM), for the grid sync
    that sums them; and at least half the SMs busy wherever there are
    enough stages."""
    kt, nt, splits, per = wgrad_simt_plan(b, h, w, cin, cout, sms)
    m = b * h * w
    assert (kt, nt) == wgrad_simt_tile(b, h, w, cin, cout)
    assert per % 16 == 0 and splits >= 1
    runs = [range(s * per, min((s + 1) * per, m)) for s in range(splits)]
    assert all(len(r) > 0 for r in runs)
    assert [p for r in runs for p in r] == list(range(m))
    tiles = -(-(9 * cin) // kt) * -(-cout // nt)
    if splits > 1:
        assert tiles * splits <= 2 * sms
    if -(-m // 16) * tiles >= sms:
        assert 2 * tiles * splits >= sms


@pytest.mark.parametrize("b,h,w,cin,cout", SIMT_PLAN_CASES)
def test_simt_plans_fit_shared_memory(b, h, w, cin, cout):
    """Every slab of a SIMT K1 plan and every SIMT K2 tile fits the 227 KB
    a block may have (K2's two an SM, as its grid sync assumes); the
    slabs cover Cin, all of it where it fits in one. Mirrors
    csrc/conv3x3.cu::simt_smem_bytes, simt_slab and
    wgrad_simt_smem_bytes."""
    bn = simt_plan(b, h, w, cin, cout, 132)[0]
    slab = simt_slab(cin, bn)
    slabs = [min(slab, cin - c0) for c0 in range(0, cin, slab)]
    assert sum(slabs) == cin and (slab % 4 == 0 or slab == cin)
    assert all(simt_smem_bytes(cs, bn) <= _SMEM_LIMIT for cs in slabs)
    if simt_smem_bytes(cin, bn) <= _SMEM_LIMIT:
        assert slabs == [cin]
    kt, nt = wgrad_simt_plan(b, h, w, cin, cout, 132)[:2]
    assert 2 * (wgrad_simt_smem_bytes(kt, nt) + 1024) <= _SM_SMEM


@pytest.mark.parametrize("sms", [132, 114])
def test_simt_plans_fill_the_card_at_the_recipe_shape(sms):
    """At the recipe's (4, 16, 16, 64) -> 64: K1 in 32-channel tiles, 4
    strips x 16 rows x 2 tiles = 128 blocks of one row; K2 9 tiles of 64 x
    64 in runs of whole stages, one block an SM at most (at 132 SMs 13
    runs of 80 pixels, 117 blocks: on an H100 faster than 22 runs of 48
    that put two on some SMs)."""
    assert simt_plan(4, 16, 16, 64, 64, sms) == (32, 1, 128)
    kt, nt, splits, per = wgrad_simt_plan(4, 16, 16, 64, 64, sms)
    assert (kt, nt) == (64, 64) and sms // 2 < 9 * splits <= sms
    assert (splits - 1) * per < 1024 <= splits * per
    if sms == 132:
        assert (splits, per) == (13, 80)


def _k1_simt_order(x: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """The SIMT K1's arithmetic in plain torch: per slab of input channels
    (simt_slab), item j = tap * quads + q (quad q: channels 4q .. 4q + 3)
    goes to group j % SK (simt_split); group k's running fp32 sum over
    its items in order, then the item's channels; the two groups of a
    warp added, s_2m + s_2m+1, and the output (...(p_0 + p_1) + ...) +
    p_(SK/2-1) over those pairs (SK = 1: s_0); each slab's sum added to
    the slabs' before it; the halo zero outside the image."""
    b, h, w, cin = x.shape
    cout = w2d.shape[1]
    slab = simt_slab(cin, simt_plan(b, h, w, cin, cout, 132)[0])
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = None
    for c0 in range(0, cin, slab):
        cs = min(slab, cin - c0)
        sk = simt_split(cs)
        quads = -(-cs // 4)
        sums = [torch.zeros(b, h, w, cout) for _ in range(sk)]
        for j in range(9 * quads):
            tap, q = divmod(j, quads)
            dy, dx = divmod(tap, 3)
            sl = xp[:, dy:dy + h, dx:dx + w, :]
            for ci in range(c0 + 4 * q, c0 + min(4 * q + 4, cs)):
                sums[j % sk] = (sums[j % sk]
                                + sl[..., ci:ci + 1] * w2d[tap * cin + ci])
        part = sums[0]
        if sk > 1:
            part = sums[0] + sums[1]
            for m in range(1, sk // 2):
                part = part + (sums[2 * m] + sums[2 * m + 1])
        out = part if out is None else out + part
    return out


def _k2_simt_order(x: torch.Tensor, g: torch.Tensor, sms: int):
    """The SIMT K2's reduction in plain torch: in each split's run of
    pixels (wgrad_simt_plan) each of the PG = 256 / (KT * NT / 64) copies
    of the tile
    sums its share of every 16-pixel stage (copy c: stage pixels 16 / PG
    * c onward), the copies added in order, then the splits' partials in
    the order s = 0, 1, ...; returns dW and the number of splits."""
    b, h, w, cin = x.shape
    cout = g.shape[3]
    kt, nt, splits, per = wgrad_simt_plan(b, h, w, cin, cout, sms)
    copies = 256 * 64 // (kt * nt)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    patches = torch.cat([xp[:, dy:dy + h, dx:dx + w, :].reshape(-1, cin)
                         for dy in range(3) for dx in range(3)], dim=1)
    g2 = g.reshape(-1, cout)
    m = b * h * w
    dw = None
    for s in range(splits):
        part = None
        for c in range(copies):
            idx = [p for p in range(s * per, min((s + 1) * per, m))
                   if (p - s * per) % 16 // (16 // copies) == c]
            mine = (patches[idx].T @ g2[idx] if idx
                    else torch.zeros(9 * cin, cout))
            part = mine if part is None else part + mine
        dw = part if dw is None else dw + part
    return dw, splits


# Ragged channels, the recipe's 64 -> 64, a 96-channel slab, and at one
# 32x32 image (the 1,024 pixels that take K2's larger tiles) Cin 128
# (K2's 128 x 64 tile, one tap) and Cout 128 (K2's 64 x 128 tile, four
# K1 tiles of 32).
SIMT_ORDER_SHAPES = [(2, 5, 7, 3, 16), (2, 16, 16, 64, 64), (1, 6, 20, 96, 24),
                     (1, 32, 32, 128, 16), (1, 32, 32, 16, 128)]


@pytest.mark.parametrize("shape", SIMT_ORDER_SHAPES)
def test_simt_k1_order_matches_pallas_fwd_kernel(shape):
    x, w2d, g = _inputs(shape, 4)
    b, h, w, cin, cout = shape
    ref = _pallas_fwd(jnp.asarray(x), jnp.asarray(w2d))
    assert max_abs(_k1_simt_order(t32(x), t32(w2d)), ref) <= TOL
    # As dx: the cotangent and the flipped, transposed weights.
    w_t = jnp.flip(jnp.asarray(w2d).reshape(3, 3, cin, cout), axis=(0, 1))
    ref = _pallas_fwd(jnp.asarray(g),
                      w_t.transpose(0, 1, 3, 2).reshape(9 * cout, cin))
    assert max_abs(_k1_simt_order(t32(g), flip_transpose(t32(w2d), cin,
                                                         cout)), ref) <= TOL


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", SIMT_ORDER_SHAPES)
def test_simt_k2_split_sum_matches_pallas_wgrad_kernel(shape, sms):
    """dW sums up to 512 products of unit normals here (|dW| up to about
    40), and the split sum adds them in another grouping than the Pallas
    kernel's dot: 2e-5 max abs for each unit of the largest |dW|."""
    x, _, g = _inputs(shape, 5)
    ref = _pallas_wgrad(jnp.asarray(x), jnp.asarray(g))
    dw, splits = _k2_simt_order(t32(x), t32(g), sms)
    assert splits > 1
    assert max_abs(dw, ref) <= TOL * max(1.0, float(np.abs(ref).max()))


# A 'space' line's K1/K2: a (2, 16, 8, 16) map cut into slices of rows,
# each with its halo operand (the neighbours' edge rows, zeros at the
# frame's edges), against the Pallas kernels over the whole map.
HALO_MAP = (2, 16, 8, 16, 16)
HALO_TOL = 1e-5


def _row_slices(t: torch.Tensor, n: int) -> list:
    """[(rows, halo)] of ``t`` cut into ``n`` slices along H; halo (B, 2,
    W, C): the row above the slice and the row below it."""
    parts = t.chunk(n, dim=1)
    zero = torch.zeros_like(parts[0][:, :1])
    return [(p.contiguous(),
             torch.cat([parts[i - 1][:, -1:] if i > 0 else zero,
                        parts[i + 1][:, :1] if i < n - 1 else zero], dim=1))
            for i, p in enumerate(parts)]


@pytest.mark.parametrize("n", [2, 4])
def test_halo_k1_k2_on_slices_match_pallas_whole_map(n):
    """Each slice's K1 with its halo is its rows of the whole map's conv,
    K1 on the cotangent's slice with the cotangent's halo its rows of the
    whole map's dx, and the slices' K2 summed the whole map's dW. fp32,
    1e-5 max abs, in units of the reference's largest magnitude for dW
    (sums of 256 products of unit normals, |dW| up to about 50, grouped
    by slice)."""
    x, w2d, g = _inputs(HALO_MAP, 6)
    b, h, w, cin, cout = HALO_MAP
    y_ref = np.asarray(_pallas_fwd(jnp.asarray(x), jnp.asarray(w2d)))
    w_t = jnp.flip(jnp.asarray(w2d).reshape(3, 3, cin, cout), axis=(0, 1))
    dx_ref = np.asarray(_pallas_fwd(
        jnp.asarray(g), w_t.transpose(0, 1, 3, 2).reshape(9 * cout, cin)))
    dw_ref = np.asarray(_pallas_wgrad(jnp.asarray(x), jnp.asarray(g)))
    w_flip = flip_transpose(t32(w2d), cin, cout)
    dw = torch.zeros(9 * cin, cout)
    for i, ((xs, xh), (gs, gh)) in enumerate(zip(_row_slices(t32(x), n),
                                                 _row_slices(t32(g), n))):
        rows = slice(i * h // n, (i + 1) * h // n)
        y = conv3x3_fwd(xs, t32(w2d), halo=xh)
        assert y.shape == (b, h // n, w, cout)
        assert max_abs(y, y_ref[:, rows]) <= HALO_TOL
        assert max_abs(conv3x3_fwd(gs, w_flip, halo=gh),
                       dx_ref[:, rows]) <= HALO_TOL
        dw = dw + conv3x3_wgrad(xs, gs, halo=xh)
    assert max_abs(dw, dw_ref) <= HALO_TOL * max(1.0, np.abs(dw_ref).max())


def test_halo_of_zeros_is_same_padding():
    """A halo of zeros is the SAME conv's own padding: the plain versions
    with and without it agree bit for bit, and so does the fp32-output K1
    on bf16 inputs."""
    x, w2d, g = _inputs((2, 5, 7, 16, 24), 7)
    zeros = torch.zeros(2, 2, 7, 16)
    assert torch.equal(conv3x3_fwd(t32(x), t32(w2d), halo=zeros),
                       conv3x3_fwd(t32(x), t32(w2d)))
    assert torch.equal(conv3x3_wgrad(t32(x), t32(g), halo=zeros),
                       conv3x3_wgrad(t32(x), t32(g)))
    xb, wb = t32(x).bfloat16(), t32(w2d).bfloat16()
    assert torch.equal(
        conv3x3_fwd(xb, wb, torch.float32, halo=zeros.bfloat16()),
        conv3x3_fwd(xb, wb, torch.float32))


@pytest.mark.parametrize("case", ["rows", "width", "channels", "dtype"])
def test_halo_of_the_wrong_shape_or_dtype_raises(case):
    x = torch.zeros(2, 4, 6, 8)
    halo = {"rows": torch.zeros(2, 3, 6, 8),
            "width": torch.zeros(2, 2, 5, 8),
            "channels": torch.zeros(2, 2, 6, 4),
            "dtype": torch.zeros(2, 2, 6, 8, dtype=torch.float64)}[case]
    error = TypeError if case == "dtype" else ValueError
    with pytest.raises(error, match="halo"):
        conv3x3_fwd(x, torch.zeros(72, 16), halo=halo)
    with pytest.raises(error, match="halo"):
        conv3x3_wgrad(x, torch.zeros(2, 4, 6, 16), halo=halo)
