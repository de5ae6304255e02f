"""Kernels K1-K8 on the card, at shapes other than the main paths': ragged
tiles, channel counts that are not multiples of 64, GroupNorm groups that
straddle the z/r split, correlation windows at stride 1, H != W, C not a
multiple of 32 and d > H, channelnorm at C = 1, 2, 3 and 64, and the
checks that make a wrapper raise.

These need an sm_90 GPU and skip elsewhere. The conftest of this folder
imports JAX, which the machine with the card lacks, so run them there as

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_port_cuda.py

Tolerances as in chip_smoke.py: fp32 max abs 1e-4 (K1) and 1e-5 (K3/K4),
K2 relative L2 1e-5 against fp64; bf16 relative L2 1e-2 (K1/K2) and max
abs 1/128 (K3/K4, |h| < 1). K5-K8 in fp32 to 1e-5 max abs against fp64
plain versions (sums of at most a few thousand products of unit normals).
In bf16 against the plain version on the same bf16 inputs: a product of
two bf16 values is exact in fp32, K6, K7 and K8 add those products in the
plain version's order and round once, so they are bit-equal; K5 sums in
another order than the plain mean, so it may round differently where the
two fp32 sums straddle a bf16 rounding boundary: 1e-4 relative L2.
"""

import pytest
import torch

from ode_rl_torch.ops import common
from ode_rl_torch.ops.channelnorm import (ChannelNormFn, channelnorm_fwd,
                                          channelnorm_plain)
from ode_rl_torch.ops.conv3x3 import (Conv3x3Fn, conv3x3_fwd,
                                      conv3x3_fwd_plain, conv3x3_wgrad)
from ode_rl_torch.ops.correlation import (CorrelationFn, correlation_bwd_f1,
                                          correlation_bwd_f1_plain,
                                          correlation_bwd_f2,
                                          correlation_bwd_f2_plain,
                                          correlation_fwd,
                                          correlation_fwd_plain,
                                          n_displacements)
from ode_rl_torch.ops.gru_gates import fused_gru_blend, fused_gru_gates

pytestmark = pytest.mark.cuda

CONV_SHAPES = [(3, 5, 7, 16, 24), (2, 3, 3, 8, 72), (5, 9, 11, 3, 5),
               (1, 16, 16, 64, 64)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator().manual_seed(0)


def _rnd(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)


def _rel_l2(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def _max_abs(a, b):
    return (a.double() - b.double()).abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv3x3_fwd_and_wgrad_match_plain(cuda, shape, dtype):
    b, h, w, cin, cout = shape
    x = _rnd(cuda, b, h, w, cin, dtype=dtype)
    g = _rnd(cuda, b, h, w, cout, dtype=dtype)
    w2d = _rnd(cuda, 9 * cin, cout, dtype=dtype, scale=(9 * cin) ** -0.5)
    out = conv3x3_fwd(x, w2d)
    dw = conv3x3_wgrad(x, g)
    torch.cuda.synchronize()
    assert out.dtype == dtype and dw.dtype == torch.float32
    if dtype == torch.float32:
        x64 = x.double()
        w64 = w2d.double().requires_grad_(True)
        ref = conv3x3_fwd_plain(x64, w64)
        (dw_ref,) = torch.autograd.grad(ref, w64, g.double())
        assert _max_abs(out, ref) <= 1e-4
        assert _rel_l2(dw, dw_ref) <= 1e-5
    else:
        with common.force_plain():
            assert _rel_l2(out, conv3x3_fwd(x, w2d)) <= 1e-2
            assert _rel_l2(dw, conv3x3_wgrad(x, g)) <= 1e-2


@pytest.mark.parametrize("shape", CONV_SHAPES[:2])
def test_conv3x3fn_gradients_match_fp64(cuda, shape):
    b, h, w, cin, cout = shape
    x = _rnd(cuda, b, h, w, cin)
    w2d = _rnd(cuda, 9 * cin, cout, scale=(9 * cin) ** -0.5)
    g = _rnd(cuda, b, h, w, cout)

    def grads(fn, dtype):
        leaves = [t.to(dtype).requires_grad_(True) for t in (x, w2d)]
        return torch.autograd.grad(fn(*leaves), leaves, g.to(dtype))

    k = grads(Conv3x3Fn.apply, torch.float32)
    p = grads(conv3x3_fwd_plain, torch.float64)
    assert _max_abs(k[0], p[0]) <= 1e-4
    assert _rel_l2(k[1], p[1]) <= 1e-5


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,groups", [(16, 1), (16, 2), (40, 4), (64, 4)])
def test_gru_gates_and_blend_match_plain(cuda, c, groups, dtype):
    """groups=1 over 2C puts z and r in one group; groups of C/G for the
    blend use max(groups // 2, 1) as ConvGRUCell does."""
    b, h, w = 3, 5, 7
    gates = _rnd(cuda, b, h, w, 2 * c, dtype=dtype)
    hs = torch.tanh(_rnd(cuda, b, h, w, c, dtype=dtype))
    cand = _rnd(cuda, b, h, w, c, dtype=dtype)
    z = torch.sigmoid(_rnd(cuda, b, h, w, c, dtype=dtype))
    gs, gb = 1 + 0.1 * _rnd(cuda, 2 * c), 0.1 * _rnd(cuda, 2 * c)
    cs, cb = 1 + 0.1 * _rnd(cuda, c), 0.1 * _rnd(cuda, c)
    g_blend = max(groups // 2, 1)
    k_gates = fused_gru_gates(gates, hs, gs, gb, groups)
    k_blend = fused_gru_blend(cand, z, hs, cs, cb, g_blend)
    with common.force_plain():
        p_gates = fused_gru_gates(gates, hs, gs, gb, groups)
        p_blend = fused_gru_blend(cand, z, hs, cs, cb, g_blend)
    tol = 1e-5 if dtype == torch.float32 else 1 / 128
    for a, r in zip((*k_gates, k_blend), (*p_gates, p_blend)):
        assert a.dtype == dtype
        assert _max_abs(a, r) <= tol


# (B, H, W, C, max_displacement, stride): ragged C, H != W, stride 1,
# d > H, every window overlapping (d <= H/2, stride 1), the FlowNetC bench
# geometry, and the FlyingChairs feature shape.
CORR_SHAPES = [(2, 5, 7, 19, 2, 1), (3, 6, 4, 40, 3, 2), (2, 3, 5, 33, 4, 1),
               (1, 8, 8, 16, 4, 1), (2, 8, 8, 256, 20, 2),
               (2, 48, 64, 256, 20, 2)]


def _corr_inputs(gen, shape, dtype):
    b, h, w, c, d, stride = shape
    n = n_displacements(d, stride)
    return (_rnd(gen, b, h, w, c, dtype=dtype),
            _rnd(gen, b, h, w, c, dtype=dtype),
            _rnd(gen, b, h, w, n * n, dtype=dtype), d, stride)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CORR_SHAPES)
def test_correlation_kernels_match_plain(cuda, shape, dtype):
    f1, f2, g, d, stride = _corr_inputs(cuda, shape, dtype)
    outs = (correlation_fwd(f1, f2, d, stride),
            correlation_bwd_f1(g, f2, d, stride),
            correlation_bwd_f2(g, f1, d, stride))
    torch.cuda.synchronize()
    ref_dtype = torch.float64 if dtype == torch.float32 else dtype
    a, b, gg = (t.to(ref_dtype) for t in (f1, f2, g))
    refs = (correlation_fwd_plain(a, b, d, stride),
            correlation_bwd_f1_plain(gg, b, d, stride),
            correlation_bwd_f2_plain(gg, a, d, stride))
    for out, ref in zip(outs, refs):
        assert out.dtype == dtype and out.shape == ref.shape
        if dtype == torch.float32:
            assert _max_abs(out, ref) <= 1e-5
    if dtype == torch.bfloat16:
        assert _rel_l2(outs[0], refs[0]) <= 1e-4
        assert torch.equal(outs[1], refs[1])
        assert torch.equal(outs[2], refs[2])


@pytest.mark.parametrize("shape", CORR_SHAPES[:4])
def test_correlationfn_gradients_match_fp64_autograd(cuda, shape):
    """K6/K7 against autograd of the fp64 plain forward, so the plain
    backward formulas are not their own reference."""
    f1, f2, g, d, stride = _corr_inputs(cuda, shape, torch.float32)

    def grads(fn, dtype):
        leaves = [t.to(dtype).requires_grad_(True) for t in (f1, f2)]
        return torch.autograd.grad(fn(*leaves, d, stride), leaves,
                                   g.to(dtype))

    k = grads(CorrelationFn.apply, torch.float32)
    p = grads(correlation_fwd_plain, torch.float64)
    for a, r in zip(k, p):
        assert _max_abs(a, r) <= 1e-5


def test_correlation_backward_is_bit_reproducible(cuda):
    f1, f2, g, d, stride = _corr_inputs(cuda, CORR_SHAPES[-1],
                                        torch.bfloat16)
    first = correlation_bwd_f2(g, f1, d, stride)
    assert torch.equal(first, correlation_bwd_f2(g, f1, d, stride))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [1, 2, 3, 64])
def test_channelnorm_kernel_matches_plain(cuda, c, dtype):
    x = _rnd(cuda, 3, 5, 7, c, dtype=dtype)
    x[0, 0, 0] = 0
    out = channelnorm_fwd(x)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (3, 5, 7, 1)
    if dtype == torch.float32:
        assert _max_abs(out, channelnorm_plain(x.double())) <= 1e-5
    else:
        with common.force_plain():
            assert torch.equal(out, channelnorm_fwd(x))
    assert out[0, 0, 0].item() == 0


def test_channelnormfn_gradient_is_zero_at_zero_norm(cuda):
    x = _rnd(cuda, 2, 4, 4, 3)
    x[0, 1, 2] = 0
    x.requires_grad_(True)
    (gx,) = torch.autograd.grad(ChannelNormFn.apply(x).sum(), x)
    norm = x.detach().double().norm(dim=-1, keepdim=True)
    expect = torch.where(norm > 0, x.detach().double() / norm.clamp_min(
        1e-12), torch.zeros_like(norm))
    assert torch.isfinite(gx).all()
    assert _max_abs(gx, expect) <= 1e-6


def test_each_wrapper_counts_its_launches(cuda):
    x = _rnd(cuda, 2, 4, 4, 8)
    common.reset_launches()
    conv3x3_fwd(x, _rnd(cuda, 72, 8))
    conv3x3_wgrad(x, x)
    fused_gru_gates(_rnd(cuda, 2, 4, 4, 16), x, _rnd(cuda, 16),
                    _rnd(cuda, 16), 2)
    fused_gru_blend(x, x, x, _rnd(cuda, 8), _rnd(cuda, 8), 1)
    g = _rnd(cuda, 2, 4, 4, 9)
    correlation_fwd(x, x, 1, 1)
    correlation_bwd_f1(g, x, 1, 1)
    correlation_bwd_f2(g, x, 1, 1)
    channelnorm_fwd(x)
    assert common.launches == {"conv3x3_fwd": 1, "conv3x3_wgrad": 1,
                               "gru_gates": 1, "gru_blend": 1,
                               "correlation_fwd": 1, "correlation_bwd_f1": 1,
                               "correlation_bwd_f2": 1, "channelnorm": 1}
    with common.force_plain():
        conv3x3_fwd(x, _rnd(cuda, 72, 8))
    assert common.launches["conv3x3_fwd"] == 1


def test_force_plain_reaches_the_backward_thread(cuda):
    x = _rnd(cuda, 2, 4, 4, 8).requires_grad_(True)
    w2d = _rnd(cuda, 72, 8).requires_grad_(True)
    common.reset_launches()
    with common.force_plain():
        Conv3x3Fn.apply(x, w2d).sum().backward()
    assert all(n == 0 for n in common.launches.values())


@pytest.mark.parametrize("case", ["non_contiguous", "mixed_dtype",
                                  "half", "cpu_weights"])
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda, case):
    x = _rnd(cuda, 2, 4, 4, 8)
    w2d = _rnd(cuda, 72, 8)
    calls = {
        "non_contiguous": lambda: conv3x3_fwd(
            _rnd(cuda, 2, 4, 8, 4).transpose(2, 3), w2d),
        "mixed_dtype": lambda: conv3x3_fwd(x.bfloat16(), w2d),
        "half": lambda: conv3x3_fwd(x.half(), w2d.half()),
        "cpu_weights": lambda: conv3x3_fwd(x, w2d.cpu()),
    }
    with pytest.raises((TypeError, ValueError)):
        calls[case]()


@pytest.mark.parametrize("case", ["corr_dtype", "corr_non_contiguous",
                                  "corr_shapes", "corr_mixed_dtype",
                                  "corr_cotangent", "bwd_f1_dtype",
                                  "bwd_f2_non_contiguous", "norm_dtype",
                                  "norm_non_contiguous"])
def test_new_wrappers_raise_on_what_the_kernels_do_not_take(cuda, case):
    x = _rnd(cuda, 2, 4, 4, 8)
    g = _rnd(cuda, 2, 4, 4, 9)
    nc = _rnd(cuda, 2, 4, 8, 4).transpose(2, 3)
    calls = {
        "corr_dtype": lambda: correlation_fwd(x.half(), x.half(), 1, 1),
        "corr_non_contiguous": lambda: correlation_fwd(nc, x, 1, 1),
        "corr_shapes": lambda: correlation_fwd(x, _rnd(cuda, 2, 4, 5, 8),
                                               1, 1),
        "corr_mixed_dtype": lambda: correlation_fwd(x, x.bfloat16(), 1, 1),
        "corr_cotangent": lambda: correlation_bwd_f1(g, x, 2, 1),
        "bwd_f1_dtype": lambda: correlation_bwd_f1(g.bfloat16(), x, 1, 1),
        "bwd_f2_non_contiguous": lambda: correlation_bwd_f2(g, nc, 1, 1),
        "norm_dtype": lambda: channelnorm_fwd(x.double()),
        "norm_non_contiguous": lambda: channelnorm_fwd(nc),
    }
    with pytest.raises((TypeError, ValueError)):
        calls[case]()
