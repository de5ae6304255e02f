"""Kernels K1-K8 on the card, at shapes other than the main paths': ragged
tiles, K1 and K2 with a halo operand on both routes (H 8, 4 and 12, W 8,
16 and 20, Cout 64 and 32, a 'space' rank at the top, the bottom or
inside), the tensor-core K1 and K2 against their SIMT twins and cuDNN
(K2 also at 32 and 96 output channels, K1 also with an fp32 output), K1's
32-channel column blocks (Cin 16, 32, 64 and 128, Cout 32, 96 and 160, W
8, 16, 24 and 33, with and without a halo, bf16 and fp32 out) and Cout 16
and 48 still in 16-channel blocks, the moments-in K3's and K4's vector
kernels against their plain versions, bit-equal to their scalar kernels,
the vector moments pass against its plain version and fp64 sums (a
sample over a cluster of blocks too), and the shapes their rules leave to
the scalar kernels,
channel counts that are not multiples of 64, the one-sample K3/K4 against
the two-pass ones and the plain versions (GroupNorm groups that straddle
the z/r split, a cluster of blocks a sample, the flagship) and the shapes
the rule sends to the two-pass kernels, correlation windows at stride 1,
H != W, C not a
multiple of 32 and d > H, the tensor-core K5-K7 against the SIMT ones
and fp64 at maps of at most 64 pixels and the shapes the rule sends to
SIMT, the SIMT K5-K7 forced at every correlation shape (the highres
trainer's maps, odd maps with C = 40, the label features; K6 also where
cells meet no partner, and at views one element into their storage) and
20 calls of them bit-equal, channelnorm at C = 1, 2, 3 and 64 and
bit-equal to the plain version at FlowNet2's maps, the checks that make a wrapper raise, and one
step of each Moving MNIST recurrent block (ConvGRU, cgrudecODE, the
memory modes nru and nru2, the sampled z0) at its full width, fp32 and
B=4, 10 -> 10 frames, through the kernels against the same step under
``force_plain()`` (same weights, batch and z0 noise; loss to 1e-5
relative, prediction to 1e-4 max abs, every gradient leaf to 1e-3
relative L2, solver stats equal; K1/K2 on SIMT, K3/K4 one-sample) on
a Moving MNIST batch from the port's generator. The sampled z0 is held
with its KL term too: stats, loss and prediction, and every gradient
leaf outside the conv encoder and the z0 encoder. The KL term's gradient
in std is -1/(std + 1e-6), which multiplies the fp32 rounding of a std
near zero by up to 1e6 in the leaves it reaches (those two), so they are
held with ``z_kl_weight`` 0.

These need an sm_90 GPU and skip elsewhere. The conftest of this folder
imports JAX, which the machine with the card lacks, so run them there as

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_port_cuda.py

Tolerances as in chip_smoke.py: fp32 max abs 1e-4 (K1) and 1e-5 (K3/K4),
K2 relative L2 1e-5 against fp64; bf16 K1 (both kernels: tensor cores and
SIMT) within one bf16 ulp of the fp64 conv of the same inputs rounded to
bf16, with at most 2e-3 of the outputs one ulp off (``common.bf16_ulps``;
readings in chip_smoke.py); bf16 K2 (both kernels) relative L2 5e-6
against fp64 and against its plain version (cuDNN's bf16 weight gradient
3e-3: its own rounding to bf16), and K3/K4 max abs 1/128 (|h| < 1)
against the plain version, and both K3/K4 kernels (one-sample and
two-pass) within one bf16 ulp of the Pallas formula in fp64, with at most
2e-3 of the outputs one ulp off. K5-K8 in fp32 to 1e-5 max abs against fp64
plain versions (sums of at most a few thousand products of unit normals).
In bf16 against the plain version on the same bf16 inputs: a product of
two bf16 values is exact in fp32, the SIMT K6 and K7 and K8 add those
products in the plain version's order and round once, so they are
bit-equal; K5 and the tensor-core K6 and K7 sum in another order than the
plain version, so they may round differently where the two fp32 sums
straddle a bf16 rounding boundary: 1e-4 relative L2. The tensor-core
K5-K7, and the SIMT ones, within one bf16 ulp of the fp64 plain versions,
with at most 1e-3 of the outputs one ulp off. K8 squares and adds in
channel order without fused multiply-adds, as the plain version does, so
at C = 2 and 3 it is bit-equal to it in fp32 too.
"""

import pytest
import torch

from ode_rl_torch.core.config import load_config
from ode_rl_torch.data.mmnist import generate_moving_mnist
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.data.sprites import get_sprite_bank
from ode_rl_torch.ops import common
from ode_rl_torch.ops.channelnorm import (ChannelNormFn, channelnorm_fwd,
                                          channelnorm_plain)
from ode_rl_torch.ops.conv3x3 import (Conv3x3Fn, _conv3x3_fwd_simt,
                                      _conv3x3_fwd_tc, _conv3x3_wgrad_simt,
                                      _conv3x3_wgrad_tc, conv3x3_fwd,
                                      conv3x3_fwd_plain, conv3x3_wgrad,
                                      conv3x3_wgrad_plain, flip_transpose,
                                      tc_nt, uses_tensor_cores)
from ode_rl_torch.ops.correlation import (CorrelationFn,
                                          _correlation_bwd_f1_simt,
                                          _correlation_bwd_f1_tc,
                                          _correlation_bwd_f2_simt,
                                          _correlation_bwd_f2_tc,
                                          _correlation_fwd_simt,
                                          _correlation_fwd_tc,
                                          correlation_bwd_f1,
                                          correlation_bwd_f1_plain,
                                          correlation_bwd_f2,
                                          correlation_bwd_f2_plain,
                                          correlation_fwd,
                                          correlation_fwd_plain,
                                          n_displacements, simt_plan,
                                          tc_plan)
from ode_rl_torch.ops.gru_gates import (_alignment, _blend_mom_plain,
                                        _blend_plain, _gates_mom_plain,
                                        _gates_plain, _gru_blend_2pass,
                                        _gru_blend_sample, _gru_gates_2pass,
                                        _gru_gates_sample, blend_f64,
                                        blend_from_moments, fused_gru_blend,
                                        fused_gru_gates, gates_f64,
                                        gates_from_moments, gru_moments,
                                        gru_moments_plain, mom_vec_plan,
                                        moments_plan, sample_plan)
from ode_rl_torch.train.step import create_train_state, loss_and_grads

pytestmark = pytest.mark.cuda

CONV_SHAPES = [(3, 5, 7, 16, 24), (2, 3, 3, 8, 72), (5, 9, 11, 3, 5),
               (1, 16, 16, 64, 64)]
DTYPES = [torch.float32, torch.bfloat16]
# Shapes the tensor-core K1 takes, forward and as dx: the flagship, B=1,
# ragged H and W, halo chunks of 16, 32 and 64 channels (two of 64 as dx
# of the last), column blocks of 16 and 64 channels (two of 64 forward of
# the last), tiles 8, 16 and 32 wide, and the unrolled (Cin 16, 32, 64)
# and runtime (Cin 48, 128) loops.
TC_SHAPES = [(128, 16, 16, 64, 64), (1, 16, 16, 64, 64), (3, 5, 7, 16, 32),
             (2, 9, 11, 32, 48), (2, 20, 33, 32, 64), (2, 12, 7, 64, 128)]
K1_BF16_ULPS, K1_BF16_SHARE = 1.0, 2e-3
# The flagship K2 and K1's card geometries at K2's channel multiples; then
# blocks of 32 output channels: a 'model' rank's Cout 32 slice, Cout 32
# and 96 over ragged H and W (tiles 8, 16 and 32 wide), two input blocks.
K2_SHAPES = [(128, 16, 16, 64, 64), (1, 16, 16, 64, 64), (3, 5, 7, 64, 64),
             (2, 9, 11, 64, 128), (2, 20, 33, 64, 64), (2, 12, 7, 128, 64),
             (128, 16, 16, 64, 32), (3, 5, 7, 64, 32), (2, 9, 11, 64, 96),
             (2, 20, 33, 64, 32), (2, 12, 7, 128, 96)]
# K1 with bf16 inputs and an fp32 output (a 'model' rank's dx partial,
# (128, 16, 16, 32) -> 64), at Cin 16, 32 and 64 over ragged W (tiles 8,
# 16 and 32 wide), fp32 boxes of 16 and 32 channels.
K1_FP32_OUT_SHAPES = [(128, 16, 16, 32, 64), (3, 5, 7, 16, 32),
                      (2, 9, 11, 32, 64), (2, 20, 33, 64, 64),
                      (2, 12, 7, 64, 16), (1, 16, 16, 16, 128)]
# bf16 K2 against fp64 and cuDNN's (bf16-rounded) weight gradient,
# relative L2; readings in chip_smoke.py.
K2_BF16_REL_L2, K2_CUDNN_REL_L2 = 5e-6, 3e-3


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


def _shifted(t):
    """A contiguous copy of t one element into its storage."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


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
        ulps, share = common.bf16_ulps(
            out, conv3x3_fwd_plain(x.double(), w2d.double()))
        assert ulps <= K1_BF16_ULPS and share <= K1_BF16_SHARE
        with common.force_plain():
            assert _rel_l2(dw, conv3x3_wgrad(x, g)) <= K2_BF16_REL_L2


def _tc_case(gen, shape, dx):
    """bf16 inputs of K1 at `shape`, forward or as dx (the cotangent with
    flip_transpose'd weights)."""
    b, h, w, cin, cout = shape
    w2d = _rnd(gen, 9 * cin, cout, dtype=torch.bfloat16,
               scale=(9 * cin) ** -0.5)
    if dx:
        return (_rnd(gen, b, h, w, cout, dtype=torch.bfloat16),
                flip_transpose(w2d, cin, cout))
    return _rnd(gen, b, h, w, cin, dtype=torch.bfloat16), w2d


@pytest.mark.parametrize("dx", [False, True], ids=["forward", "dx"])
@pytest.mark.parametrize("shape", TC_SHAPES)
def test_tensor_core_k1_matches_simt_and_plain(cuda, shape, dx):
    """The tensor-core K1, the SIMT K1 and the plain version, each within
    one bf16 ulp of the fp64 conv; the dispatcher picks the tensor cores."""
    x, w2d = _tc_case(cuda, shape, dx)
    ref = conv3x3_fwd_plain(x.double(), w2d.double())
    common.reset_launches()
    out = conv3x3_fwd(x, w2d)
    assert common.launches["conv3x3_fwd_tc"] == 1
    assert torch.equal(out, _conv3x3_fwd_tc(x, w2d))
    for got in (out, _conv3x3_fwd_simt(x, w2d), conv3x3_fwd_plain(x, w2d)):
        ulps, share = common.bf16_ulps(got, ref)
        assert ulps <= K1_BF16_ULPS and share <= K1_BF16_SHARE


@pytest.mark.parametrize("dx", [False, True], ids=["forward", "dx"])
def test_tensor_core_k1_is_bit_reproducible(cuda, dx):
    x, w2d = _tc_case(cuda, TC_SHAPES[0], dx)
    first = _conv3x3_fwd_tc(x, w2d)
    for _ in range(20):
        assert torch.equal(first, _conv3x3_fwd_tc(x, w2d))


@pytest.mark.parametrize("arg", ["x", "w"])
def test_tensor_core_k1_raises_on_a_misaligned_pointer(cuda, arg):
    """A contiguous view one element into its storage: TMA needs 16-byte
    aligned addresses, and the wrapper raises rather than reroutes."""
    x, w2d = _tc_case(cuda, (1, 16, 16, 64, 64), False)

    args = {"x": (_shifted(x), w2d), "w": (x, _shifted(w2d))}[arg]
    with pytest.raises(ValueError, match="16-byte aligned"):
        conv3x3_fwd(*args)


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_tensor_core_k2_matches_simt_cudnn_and_fp64(cuda, shape):
    """K1's card geometries (ragged H and W, B=1, tiles 8, 16 and 32 wide)
    at K2's channel multiples, Cin != Cout both ways: the dispatcher picks
    the tensor cores; the tensor-core K2 and the SIMT K2 within the limit
    of the fp64 patches^T . g, cuDNN within its bf16 rounding."""
    b, h, w, cin, cout = shape
    x = _rnd(cuda, b, h, w, cin, dtype=torch.bfloat16)
    g = _rnd(cuda, b, h, w, cout, dtype=torch.bfloat16)
    ref = conv3x3_wgrad_plain(x.double(), g.double())
    common.reset_launches()
    dw = conv3x3_wgrad(x, g)
    assert common.launches["conv3x3_wgrad_tc"] == 1
    assert torch.equal(dw, _conv3x3_wgrad_tc(x, g))
    assert _rel_l2(dw, ref) <= K2_BF16_REL_L2
    assert _rel_l2(_conv3x3_wgrad_simt(x, g), ref) <= K2_BF16_REL_L2
    # cuDNN's weight gradient, (Cout, Cin, 3, 3) in bf16, as (9*Cin, Cout).
    w_oihw = torch.zeros(cout, cin, 3, 3, device="cuda", dtype=torch.bfloat16)
    lib = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w_oihw, None, [1, 1],
        [1, 1], [1, 1], False, [0, 0], 1, [False, True, False])[1]
    lib = lib.permute(2, 3, 1, 0).reshape(9 * cin, cout)
    assert _rel_l2(lib, ref) <= K2_CUDNN_REL_L2


def test_tensor_core_k2_is_bit_reproducible(cuda):
    b, h, w, cin, cout = K2_SHAPES[0]
    x = _rnd(cuda, b, h, w, cin, dtype=torch.bfloat16)
    g = _rnd(cuda, b, h, w, cout, dtype=torch.bfloat16)
    first = _conv3x3_wgrad_tc(x, g)
    for _ in range(20):
        assert torch.equal(first, _conv3x3_wgrad_tc(x, g))


def test_tensor_core_k2_at_32_output_channels_is_bit_reproducible(cuda):
    x = _rnd(cuda, 128, 16, 16, 64, dtype=torch.bfloat16)
    g = _rnd(cuda, 128, 16, 16, 32, dtype=torch.bfloat16)
    first = _conv3x3_wgrad_tc(x, g)
    for _ in range(20):
        assert torch.equal(first, _conv3x3_wgrad_tc(x, g))


@pytest.mark.parametrize("dx", [False, True], ids=["forward", "dx"])
@pytest.mark.parametrize("shape", K1_FP32_OUT_SHAPES)
def test_tensor_core_k1_fp32_output_matches_plain(cuda, shape, dx):
    """bf16 in, fp32 out: the dispatcher picks the tensor cores; the fp32
    sums within 1e-4 max abs (chip_smoke.py's "conv3x3_fwd as dx") of the
    plain version (F.conv2d of the values in fp32, TF32 off) and of the
    fp32 SIMT K1 on the same values, and within 1e-5 relative L2 of the
    fp64 conv; 20 calls bit-equal."""
    x, w2d = _tc_case(cuda, shape, dx)
    common.reset_launches()
    out = conv3x3_fwd(x, w2d, out_dtype=torch.float32)
    assert common.launches["conv3x3_fwd_tc"] == 1
    assert out.dtype == torch.float32
    with common.force_plain():
        plain = conv3x3_fwd(x, w2d, out_dtype=torch.float32)
    assert _max_abs(out, plain) <= 1e-4
    assert _max_abs(out, _conv3x3_fwd_simt(x.float(), w2d.float())) <= 1e-4
    assert _rel_l2(out, conv3x3_fwd_plain(x.double(), w2d.double())) <= 1e-5
    for _ in range(20):
        assert torch.equal(out, _conv3x3_fwd_tc(x, w2d, torch.float32))


def test_k1_fp32_output_off_the_tensor_cores_takes_fp32_simt(cuda):
    """Outside the tensor-core rule (Cin 8), bf16 in and fp32 out is the
    fp32 SIMT K1 on the same values, bit for bit."""
    x, w2d = _tc_case(cuda, (2, 5, 7, 8, 24), False)
    common.reset_launches()
    out = conv3x3_fwd(x, w2d, out_dtype=torch.float32)
    assert common.launches["conv3x3_fwd_simt"] == 1
    assert torch.equal(out, _conv3x3_fwd_simt(x.float(), w2d.float()))


# K1's column blocks of 32 channels: Cin 16, 32 and 64 (the unrolled
# loop, KS 1, 2, 4) and 128 (the runtime loop), Cout 32, 96 and 160, W 8,
# 16, 24 and 33 (tiles 8, 16, 32 and 32 wide, ragged), each with and
# without a halo and with bf16 and fp32 outputs; the shapes whose plan
# fits no block take SIMT, as the rule says.
NT32_CASES = [(cin, cout, w) for cin in (16, 32, 64, 128)
              for cout in (32, 96, 160) for w in (8, 16, 24, 33)]


@pytest.mark.parametrize("case", NT32_CASES,
                         ids=lambda c: "cin{}-cout{}-w{}".format(*c))
def test_k1_in_32_channel_blocks_matches_plain(cuda, case):
    """bf16 out within one bf16 ulp of the fp64 conv (at most 2e-3 of the
    outputs one off), fp32 out within 1e-4 max abs of its plain version
    and 1e-5 relative L2 of fp64; the launch counted under NT 32 wherever
    the rule takes the tensor cores; a second call bit-equal; whether NT
    16 on the same inputs is bit-equal is printed."""
    cin, cout, w = case
    for halo_on in (False, True):
        x, halo, w2d, _ = _halo_case(cuda, 2, 12, w, cin, cout, "interior",
                                     torch.bfloat16)
        halo = halo if halo_on else None
        h64 = None if halo is None else halo.double()
        ref = conv3x3_fwd_plain(x.double(), w2d.double(), halo=h64)
        for out in (torch.bfloat16, torch.float32):
            tc = uses_tensor_cores(torch.bfloat16, cin, cout, w, out)
            common.reset_launches()
            y = conv3x3_fwd(x, w2d, out_dtype=out, halo=halo)
            assert common.launches["conv3x3_fwd_tc"] == int(tc)
            if tc:
                assert tc_nt(cout, cin, w, out, halo_on) == 32
                assert common.launches["conv3x3_fwd_nt32"] == 1
                assert torch.equal(y, _conv3x3_fwd_tc(x, w2d, out, halo))
                nt16 = _conv3x3_fwd_tc(x, w2d, out, halo, nt=16)
                print(f"cin {cin} cout {cout} w {w} halo {halo_on} {out}: "
                      f"NT 32 bit-equal to NT 16 {torch.equal(y, nt16)}")
            if out == torch.bfloat16:
                ulps, share = common.bf16_ulps(y, ref)
                assert ulps <= K1_BF16_ULPS and share <= K1_BF16_SHARE
            else:
                with common.force_plain():
                    plain = conv3x3_fwd(x, w2d, out_dtype=out, halo=halo)
                assert _max_abs(y, plain) <= 1e-4
                assert _rel_l2(y, ref) <= 1e-5


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("halo_on", [False, True])
def test_k1_in_32_channel_blocks_is_bit_reproducible(cuda, halo_on, out):
    """A 'model' rank's forward, (128, 16, 16, 64) -> 32 (a 'space'-shaped
    halo where asked): 20 calls bit-equal."""
    x, halo, w2d, _ = _halo_case(cuda, 128, 16, 16, 64, 32, "interior",
                                 torch.bfloat16)
    halo = halo if halo_on else None
    common.reset_launches()
    first = conv3x3_fwd(x, w2d, out_dtype=out, halo=halo)
    assert common.launches["conv3x3_fwd_nt32"] == 1
    for _ in range(20):
        assert torch.equal(first, conv3x3_fwd(x, w2d, out_dtype=out,
                                              halo=halo))


@pytest.mark.parametrize("cout", [16, 48])
def test_k1_at_cout_16_and_48_keeps_16_channel_blocks(cuda, cout):
    x, w2d = _tc_case(cuda, (2, 9, 11, 32, cout), False)
    common.reset_launches()
    y = conv3x3_fwd(x, w2d)
    assert (common.launches["conv3x3_fwd_tc"],
            common.launches["conv3x3_fwd_nt16"],
            common.launches["conv3x3_fwd_nt32"]) == (1, 1, 0)
    ulps, share = common.bf16_ulps(y, conv3x3_fwd_plain(x.double(),
                                                        w2d.double()))
    assert ulps <= K1_BF16_ULPS and share <= K1_BF16_SHARE


@pytest.mark.parametrize("arg", ["x", "g"])
def test_tensor_core_k2_raises_on_a_misaligned_pointer(cuda, arg):
    x = _rnd(cuda, 1, 16, 16, 64, dtype=torch.bfloat16)
    g = _rnd(cuda, 1, 16, 16, 64, dtype=torch.bfloat16)

    args = {"x": (_shifted(x), g), "g": (x, _shifted(g))}[arg]
    with pytest.raises(ValueError, match="16-byte aligned"):
        conv3x3_wgrad(*args)


# K1 and K2 with a halo operand (a 'space' rank's rows): H 8 (a rank's
# rows at the flagship), 4 and 12 (a ragged second tile, its row H from
# the halo), W 8, 16 and 20 (tiles 8, 16 and 32 wide), Cout 64 and 32
# (K1's 64- and 16-channel column blocks, K2's NT 64 and 32), and a rank
# at the top (halo row 0 zeros), the bottom (row 1 zeros) or inside.
HALO_CASES = [(h, w, cout, where) for h in (8, 4, 12) for w in (8, 16, 20)
              for cout in (64, 32) for where in ("top", "bottom", "interior")]
# The tensor-core K1 with a halo at halo chunks of 16 channels (rows
# padded to 128 bytes, loaded row by row; one chunk and three) and of 32
# (one and three); HALO_CASES take chunks of 64.
HALO_K1_CIN = [16, 32, 48, 96]


def _halo_case(gen, b, h, w, cin, cout, where, dtype):
    """x, its halo (the rows past the frame zeros), w2d and g."""
    x = _rnd(gen, b, h, w, cin, dtype=dtype)
    halo = _rnd(gen, b, 2, w, cin, dtype=dtype)
    if where == "top":
        halo[:, 0] = 0
    elif where == "bottom":
        halo[:, 1] = 0
    w2d = _rnd(gen, 9 * cin, cout, dtype=dtype, scale=(9 * cin) ** -0.5)
    return x, halo, w2d, _rnd(gen, b, h, w, cout, dtype=dtype)


@pytest.mark.parametrize("case", HALO_CASES,
                         ids=lambda c: "h{}-w{}-cout{}-{}".format(*c))
def test_halo_k1_k2_match_fp64_on_both_routes(cuda, case):
    """bf16: the tensor-core K1 and K2 (the rule's route) and the SIMT
    ones with a halo against their plain versions in fp64 (K1 one bf16
    ulp, at most 2e-3 of the outputs one off; K2 5e-6 relative L2); fp32:
    the SIMT K1 and K2 (the rule's route) 1e-4 max abs and 1e-5 relative
    L2 from fp64."""
    h, w, cout, where = case
    x, halo, w2d, g = _halo_case(cuda, 2, h, w, 64, cout, where,
                                 torch.bfloat16)
    y_ref = conv3x3_fwd_plain(x.double(), w2d.double(), halo=halo.double())
    dw_ref = conv3x3_wgrad_plain(x.double(), g.double(), halo.double())
    common.reset_launches()
    y, dw = conv3x3_fwd(x, w2d, halo=halo), conv3x3_wgrad(x, g, halo=halo)
    assert y.shape == (2, h, w, cout)
    assert common.launches["conv3x3_fwd_tc"] == 1
    assert common.launches["conv3x3_wgrad_tc"] == 1
    assert common.launches["conv3x3_fwd_halo"] == 1
    assert common.launches["conv3x3_wgrad_halo"] == 1
    assert common.halo_heights == {h}
    for got in (y, _conv3x3_fwd_simt(x, w2d, halo)):
        ulps, share = common.bf16_ulps(got, y_ref)
        assert ulps <= K1_BF16_ULPS and share <= K1_BF16_SHARE
    for got in (dw, _conv3x3_wgrad_simt(x, g, halo)):
        assert _rel_l2(got, dw_ref) <= K2_BF16_REL_L2
    x, halo, w2d, g = (t.float() for t in (x, halo, w2d, g))
    common.reset_launches()
    assert _max_abs(conv3x3_fwd(x, w2d, halo=halo), y_ref) <= 1e-4
    assert _rel_l2(conv3x3_wgrad(x, g, halo=halo), dw_ref) <= 1e-5
    assert common.launches["conv3x3_fwd_simt"] == 1
    assert common.launches["conv3x3_wgrad_simt"] == 1


@pytest.mark.parametrize("cin", HALO_K1_CIN)
def test_tensor_core_k1_with_a_halo_at_each_chunk_width(cuda, cin):
    """The tensor-core K1 with a halo, forward and as dx (the cotangent's
    halo, flipped weights), at H 12 and W 20 against fp64."""
    x, halo, w2d, g = _halo_case(cuda, 2, 12, 20, cin, 32, "interior",
                                 torch.bfloat16)
    g_halo = _rnd(cuda, 2, 2, 20, 32, dtype=torch.bfloat16)
    w_t = flip_transpose(w2d, cin, 32)
    for a, ah, wt in ((x, halo, w2d), (g, g_halo, w_t)):
        ref = conv3x3_fwd_plain(a.double(), wt.double(), halo=ah.double())
        ulps, share = common.bf16_ulps(_conv3x3_fwd_tc(a, wt, halo=ah), ref)
        assert ulps <= K1_BF16_ULPS and share <= K1_BF16_SHARE


def test_halo_k1_k2_are_bit_reproducible(cuda):
    """A 'space' rank's shape at the flagship: 20 calls bit-equal."""
    x, halo, w2d, g = _halo_case(cuda, 128, 8, 16, 64, 64, "interior",
                                 torch.bfloat16)
    y, dw = _conv3x3_fwd_tc(x, w2d, halo=halo), _conv3x3_wgrad_tc(x, g, halo)
    for _ in range(20):
        assert torch.equal(y, _conv3x3_fwd_tc(x, w2d, halo=halo))
        assert torch.equal(dw, _conv3x3_wgrad_tc(x, g, halo))


@pytest.mark.parametrize("dtype", DTYPES)
def test_halo_misaligned_raises_on_every_route(cuda, dtype):
    x, halo, w2d, g = _halo_case(cuda, 1, 8, 16, 64, 64, "top", dtype)
    with pytest.raises(ValueError, match="halo is not 16-byte aligned"):
        conv3x3_fwd(x, w2d, halo=_shifted(halo))
    with pytest.raises(ValueError, match="halo is not 16-byte aligned"):
        conv3x3_wgrad(x, g, halo=_shifted(halo))


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


# The SIMT K1 and K2 (simt_plan, wgrad_simt_plan): Cin 1, 3, 8, 16, 40,
# 64, 96, 128 and 160 (K1 splitting a row's products over 1, 2, 4, 8 and
# 16 groups; at 160 two slabs of 80 channels, the second adding to the
# first's output; ragged tiles of dW in K2), Cout 1, 16, 20, 24, 64 and
# 128 (K1's 16- and 32-channel tiles), H and W that are not multiples of
# the 16-column strip, one split (M <= 16), the recipe's (4, 16, 16, 64),
# the Vid-ODE field's (4, 16, 16, 128 -> 64) and its three 32x32 shapes,
# and fp32 at B=128.
SIMT_SHAPES = [(3, 5, 7, 1, 16), (1, 3, 5, 3, 16), (2, 9, 11, 3, 64),
               (3, 6, 17, 8, 20), (2, 17, 33, 16, 1), (2, 9, 11, 40, 24),
               (4, 16, 16, 64, 64), (1, 6, 20, 96, 128), (2, 12, 7, 64, 128),
               (1, 5, 7, 160, 24), (4, 16, 16, 128, 64)]
# The Vid-ODE field's convs at mgif's and penn's 128x128 frames.
SIMT_WIDE_SHAPES = [(4, 32, 32, 128, 64), (4, 32, 32, 64, 128),
                    (4, 32, 32, 64, 64)]


def _simt_case(gen, shape, dtype):
    b, h, w, cin, cout = shape
    return (_rnd(gen, b, h, w, cin, dtype=dtype),
            _rnd(gen, 9 * cin, cout, dtype=dtype, scale=(9 * cin) ** -0.5),
            _rnd(gen, b, h, w, cout, dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SIMT_SHAPES + SIMT_WIDE_SHAPES
                         + [(128, 16, 16, 64, 64)])
def test_simt_k1_k2_match_fp64(cuda, shape, dtype):
    """The SIMT K1 (forward and as dx) and K2 against fp64 of the same
    inputs, each bit-equal on a second call and on views one element into
    their storage (element loads instead of 16-byte ones: the same products
    in the same order); an fp32 call of the public wrappers takes them."""
    b, h, w, cin, cout = shape
    x, w2d, g = _simt_case(cuda, shape, dtype)
    w_t = flip_transpose(w2d, cin, cout)
    out, dx = _conv3x3_fwd_simt(x, w2d), _conv3x3_fwd_simt(g, w_t)
    dw = _conv3x3_wgrad_simt(x, g)
    if dtype == torch.float32:
        common.reset_launches()
        assert torch.equal(out, conv3x3_fwd(x, w2d))
        assert torch.equal(dx, conv3x3_fwd(g, w_t))
        assert torch.equal(dw, conv3x3_wgrad(x, g))
        assert common.launches["conv3x3_fwd_simt"] == 2
        assert common.launches["conv3x3_wgrad_simt"] == 1
    for got, args in ((out, (x, w2d)), (dx, (g, w_t))):
        assert torch.equal(got, _conv3x3_fwd_simt(*args))
        assert torch.equal(got, _conv3x3_fwd_simt(*map(_shifted, args)))
    assert torch.equal(dw, _conv3x3_wgrad_simt(x, g))
    assert torch.equal(dw, _conv3x3_wgrad_simt(_shifted(x), _shifted(g)))
    dw_ref = conv3x3_wgrad_plain(x.double(), g.double())
    for got, (xi, wi) in ((out, (x, w2d)), (dx, (g, w_t))):
        ref = conv3x3_fwd_plain(xi.double(), wi.double())
        if dtype == torch.float32:
            assert _max_abs(got, ref) <= 1e-4
        else:
            ulps, share = common.bf16_ulps(got, ref)
            assert ulps <= K1_BF16_ULPS and share <= K1_BF16_SHARE
    assert _rel_l2(dw, dw_ref) <= (1e-5 if dtype == torch.float32
                                   else K2_BF16_REL_L2)


@pytest.mark.parametrize("shape", [(4, 16, 16, 64, 64), (4, 16, 16, 128, 64),
                                   *SIMT_WIDE_SHAPES])
def test_simt_k1_k2_are_bit_reproducible(cuda, shape):
    """20 calls at the recipe's fp32 shape, as chip_smoke.py phase 9, and
    at the Vid-ODE field's wide ones."""
    x, w2d, g = _simt_case(cuda, shape, torch.float32)
    first = (_conv3x3_fwd_simt(x, w2d), _conv3x3_wgrad_simt(x, g))
    for _ in range(20):
        assert torch.equal(first[0], _conv3x3_fwd_simt(x, w2d))
        assert torch.equal(first[1], _conv3x3_wgrad_simt(x, g))


@pytest.mark.parametrize("cin,cout", [(128, 64), (64, 128)])
def test_simt_halo_halves_match_the_whole_map(cuda, cin, cout):
    """fp32 SIMT K1 and K2 on the two 8-row halves of a (2, 16, 32) map
    at the Vid-ODE field's widths, each with its halo operand (the other
    half's edge row, zeros at the frame), against fp64 of the whole map:
    K1 1e-4 max abs on each half's rows, K2's sum over the halves 1e-5
    relative L2."""
    x, w2d, g = _simt_case(cuda, (2, 16, 32, cin, cout), torch.float32)
    y_ref = conv3x3_fwd_plain(x.double(), w2d.double())
    dw_ref = conv3x3_wgrad_plain(x.double(), g.double())
    zero = torch.zeros_like(x[:, :1])
    halves = ((x[:, :8], torch.cat([zero, x[:, 8:9]], dim=1)),
              (x[:, 8:], torch.cat([x[:, 7:8], zero], dim=1)))
    dw = torch.zeros_like(dw_ref, dtype=torch.float32)
    for i, (rows, halo) in enumerate(halves):
        rows, halo = rows.contiguous(), halo.contiguous()
        y = _conv3x3_fwd_simt(rows, w2d, halo)
        assert _max_abs(y, y_ref[:, 8 * i:8 * i + 8]) <= 1e-4
        dw = dw + _conv3x3_wgrad_simt(rows, g[:, 8 * i:8 * i + 8].contiguous(),
                                      halo)
    assert _rel_l2(dw, dw_ref) <= 1e-5


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


# K3/K4 cases (B, H, W, C, groups of gates, dtype): the earlier (C,
# groups) cases at a ragged 5 x 7 map, a group straddling the z/r split
# (2C = 96 in 3 groups), an fp32 map of 1,024 pixels that the plan splits
# over a cluster of 4 blocks, and the flagship in bf16 (B=128) and fp32
# (B=8). The blend takes max(groups // 2, 1) groups, as ConvGRUCell does.
GRU_CASES = [(3, 5, 7, c, g, dtype) for c, g in ((16, 1), (16, 2), (40, 4),
                                                (64, 4), (48, 3))
             for dtype in DTYPES]
GRU_CASES += [(2, 32, 32, 64, 4, torch.float32),
              (128, 16, 16, 64, 4, torch.bfloat16),
              (8, 16, 16, 64, 4, torch.float32)]
# bf16 K3/K4 against the fp64 Pallas formula: one ulp, as chip_smoke.py;
# the share one ulp off at 2e-3, not chip_smoke.py's 5e-4, since a 5 x 7
# map has only 1,680 outputs a tensor (readings at the flagship shape,
# 2.1M outputs: 8.6e-6 to 3.4e-5).
K34_BF16_ULPS, K34_BF16_SHARE = 1.0, 2e-3


def _gru_case(gen, b, h, w, c, groups, dtype):
    """K3's and K4's inputs: (gates, h, scale, bias, groups) and (cand, z,
    h, scale, bias, groups of the blend)."""
    hs = torch.tanh(_rnd(gen, b, h, w, c, dtype=dtype))
    gates = (_rnd(gen, b, h, w, 2 * c, dtype=dtype), hs,
             1 + 0.1 * _rnd(gen, 2 * c), 0.1 * _rnd(gen, 2 * c), groups)
    blend = (_rnd(gen, b, h, w, c, dtype=dtype),
             torch.sigmoid(_rnd(gen, b, h, w, c, dtype=dtype)), hs,
             1 + 0.1 * _rnd(gen, c), 0.1 * _rnd(gen, c), max(groups // 2, 1))
    return gates, blend


_K34 = {"gates": (_gru_gates_sample, _gru_gates_2pass, _gates_plain,
                  gates_f64),
        "blend": (_gru_blend_sample, _gru_blend_2pass, _blend_plain,
                  blend_f64)}


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("case", GRU_CASES)
def test_gru_sample_kernels_match_two_pass_and_plain(cuda, case):
    """The rule's kernel is the one-sample kernel wherever sample_plan has
    a plan (raising outside it); the one-sample and two-pass kernels
    against each other and the plain versions: fp32 to 1e-5 max abs, bf16
    within one ulp of the fp64 Pallas formula."""
    b, h, w, c, groups, dtype = case
    for kind, args in zip(("gates", "blend"),
                          _gru_case(cuda, b, h, w, c, groups, dtype)):
        sample, two_pass, plain, f64 = _K34[kind]
        blend = kind == "blend"
        planned = sample_plan(b, h * w, c, args[-1], dtype,
                              _alignment(*(t.data_ptr() for t in args[:-3])),
                              blend)
        name = f"gru_{kind}"
        common.reset_launches()
        public = _tuple(fused_gru_blend(*args) if blend
                        else fused_gru_gates(*args))
        assert common.launches[f"{name}_sample"] == int(planned is not None)
        assert common.launches[f"{name}_2pass"] == int(planned is None)
        outs = [_tuple(two_pass(*args))]
        if planned is None:
            with pytest.raises(ValueError, match="one-sample"):
                sample(*args)
        else:
            outs.append(_tuple(sample(*args)))
            assert all(torch.equal(a, r) for a, r in zip(public, outs[-1]))
        torch.cuda.synchronize()
        if dtype == torch.float32:
            refs = _tuple(plain(*args))
            for out in outs:
                for a, r in zip(out, refs):
                    assert a.dtype == dtype and _max_abs(a, r) <= 1e-5
        else:
            refs = _tuple(f64(*args))
            for out in outs:
                for a, r in zip(out, refs):
                    ulps, share = common.bf16_ulps(a, r)
                    assert ulps <= K34_BF16_ULPS and share <= K34_BF16_SHARE


@pytest.mark.parametrize("case", [GRU_CASES[-2], GRU_CASES[-3]])
def test_gru_sample_kernels_are_bit_reproducible(cuda, case):
    """20 calls at the flagship (bf16) and across a cluster (fp32)."""
    for kind, args in zip(("gates", "blend"), _gru_case(cuda, *case)):
        sample = _K34[kind][0]
        first = _tuple(sample(*args))
        for _ in range(20):
            assert all(torch.equal(a, r)
                       for a, r in zip(first, _tuple(sample(*args))))


@pytest.mark.parametrize("refused", ["group_vectors", "misaligned",
                                     "beyond_8_blocks"])
def test_refused_gru_shapes_take_the_two_pass_kernel(cuda, refused):
    """bf16 groups of 20 channels (40 bytes), a view one element into its
    storage, and an fp32 sample of 4,096 pixels (14 blocks' worth of
    shared memory): the rule names the two-pass kernel, which runs and
    matches the plain version (fp32) or the fp64 formula (bf16); nothing
    is raised or caught."""
    shape = {"group_vectors": (2, 5, 7, 40, 4, torch.bfloat16),
             "misaligned": (2, 16, 16, 64, 4, torch.bfloat16),
             "beyond_8_blocks": (1, 64, 64, 64, 4, torch.float32)}[refused]
    gates, blend = _gru_case(cuda, *shape)
    if refused == "misaligned":
        gates = (_shifted(gates[0]), *gates[1:])
        blend = (_shifted(blend[0]), *blend[1:])
    b, h, w, c, _, dtype = shape
    assert sample_plan(b, h * w, c, gates[-1], dtype, _alignment(
        *(t.data_ptr() for t in gates[:2]))) is None
    assert sample_plan(b, h * w, c, blend[-1], dtype, _alignment(
        *(t.data_ptr() for t in blend[:3])), True) is None
    common.reset_launches()
    k = (*fused_gru_gates(*gates), fused_gru_blend(*blend))
    assert common.launches["gru_gates_2pass"] == 1
    assert common.launches["gru_blend_2pass"] == 1
    assert common.launches["gru_gates_sample"] == 0
    assert common.launches["gru_blend_sample"] == 0
    if dtype == torch.float32:
        with common.force_plain():
            refs = (*fused_gru_gates(*gates), fused_gru_blend(*blend))
        for a, r in zip(k, refs):
            assert _max_abs(a, r) <= 1e-5
    else:
        for a, r in zip(k, (*gates_f64(*gates), blend_f64(*blend))):
            ulps, share = common.bf16_ulps(a, r)
            assert ulps <= K34_BF16_ULPS and share <= K34_BF16_SHARE


# The moments-in K3 (a 'space' rank's epilogue): (B, H, W, C, groups,
# dtype). G 4 over 2C = 128 (a 'space' rank's slice of the flagship), G 3
# over 2C = 96 (a group straddling the z/r split), a ragged 8 x 13 map,
# narrow channels; fp32 and bf16.
MOM_VEC_CASES = [(b, h, w, c, g, dtype)
                 for b, h, w, c, g in ((4, 8, 16, 64, 4), (3, 8, 13, 48, 3),
                                       (2, 8, 13, 64, 4), (3, 5, 7, 16, 1))
                 for dtype in DTYPES]


def _mom_case(gen, b, h, w, c, groups, dtype):
    """gates, h, their moments, scale, bias, groups, count."""
    gates = _rnd(gen, b, h, w, 2 * c, dtype=dtype)
    hs = torch.tanh(_rnd(gen, b, h, w, c, dtype=dtype))
    return (gates, hs, gru_moments(gates, groups), 1 + 0.1 * _rnd(gen, 2 * c),
            0.1 * _rnd(gen, 2 * c), groups,
            float(h * w * (2 * c // groups)))


@pytest.mark.parametrize("case", MOM_VEC_CASES,
                         ids=lambda c: "{}x{}x{}x{}-g{}-{}".format(
                             *c[:5], str(c[5])[6:]))
def test_mom_vec_k3_matches_plain_and_scalar(cuda, case):
    """The rule takes the vector kernel; it is bit-equal to the scalar
    kernel on the same moments, within 1e-5 max abs of the plain version
    in fp32 and one bf16 ulp of the fp64 formula in bf16 (at most 2e-3 of
    the outputs one off); 20 calls bit-equal."""
    b, h, w, c, groups, dtype = case
    args = _mom_case(cuda, *case)
    assert mom_vec_plan(b, h * w, c, groups, dtype, _alignment(
        args[0].data_ptr(), args[1].data_ptr())) is not None
    common.reset_launches()
    out = gates_from_moments(*args)
    assert (common.launches["gru_gates_mom_vec"],
            common.launches["gru_gates_mom_scalar"],
            common.launches["gru_gates_mom"]) == (1, 0, 1)
    scalar = gates_from_moments(*args, kernel="scalar")
    assert common.launches["gru_gates_mom_scalar"] == 1
    assert all(torch.equal(a, r) for a, r in zip(out, scalar))
    if dtype == torch.float32:
        for a, r in zip(out, _gates_mom_plain(*args)):
            assert _max_abs(a, r) <= 1e-5
    else:
        for a, r in zip(out, gates_f64(*args[:2], *args[3:6])):
            ulps, share = common.bf16_ulps(a, r)
            assert ulps <= K34_BF16_ULPS and share <= K34_BF16_SHARE
    for _ in range(20):
        assert all(torch.equal(a, r)
                   for a, r in zip(out, gates_from_moments(*args)))


@pytest.mark.parametrize("refused", ["group_vectors", "misaligned",
                                     "narrow"])
def test_refused_mom_shapes_take_the_scalar_kernel(cuda, refused):
    """bf16 groups of 20 channels (40 bytes), a view one element into its
    storage, bf16 h of 4 channels (8 bytes): the rule names the scalar
    kernel, which matches the fp64 formula; asking for the vector kernel
    raises."""
    shape = {"group_vectors": (2, 5, 7, 40, 4), "misaligned": (2, 8, 16, 64, 4),
             "narrow": (2, 5, 7, 4, 1)}[refused]
    args = _mom_case(cuda, *shape, torch.bfloat16)
    if refused == "misaligned":
        args = (_shifted(args[0]), *args[1:])
    common.reset_launches()
    out = gates_from_moments(*args)
    assert (common.launches["gru_gates_mom_vec"],
            common.launches["gru_gates_mom_scalar"]) == (0, 1)
    with pytest.raises(ValueError, match="vector kernel"):
        gates_from_moments(*args, kernel="vec")
    for a, r in zip(out, gates_f64(*args[:2], *args[3:6])):
        ulps, share = common.bf16_ulps(a, r)
        assert ulps <= K34_BF16_ULPS and share <= K34_BF16_SHARE


# The moments-in K4 (a 'space' rank's blend): (B, H, W, C, groups, dtype).
# G 2 over C 64 (a 'space' rank's slice of the flagship), groups of 16
# channels (C 48, G 3), a ragged 8 x 13 map, narrow channels (C 16, G 1),
# a 16 x 32 map (the whole frame's pixels); fp32 and bf16.
BLEND_MOM_VEC_CASES = [(b, h, w, c, g, dtype)
                       for b, h, w, c, g in ((4, 8, 16, 64, 2),
                                             (3, 8, 13, 48, 3),
                                             (2, 8, 13, 64, 2),
                                             (3, 5, 7, 16, 1),
                                             (2, 16, 32, 64, 2))
                       for dtype in DTYPES]


def _blend_mom_case(gen, b, h, w, c, groups, dtype):
    """cand, z, h, cand's moments, scale, bias, groups, count."""
    cand = _rnd(gen, b, h, w, c, dtype=dtype)
    z = torch.sigmoid(_rnd(gen, b, h, w, c, dtype=dtype))
    hs = torch.tanh(_rnd(gen, b, h, w, c, dtype=dtype))
    return (cand, z, hs, gru_moments(cand, groups), 1 + 0.1 * _rnd(gen, c),
            0.1 * _rnd(gen, c), groups, float(h * w * (c // groups)))


@pytest.mark.parametrize("case", BLEND_MOM_VEC_CASES,
                         ids=lambda c: "{}x{}x{}x{}-g{}-{}".format(
                             *c[:5], str(c[5])[6:]))
def test_mom_vec_k4_matches_plain_and_scalar(cuda, case):
    """The rule takes the vector K4; it is bit-equal to the scalar kernel
    on the same moments (both blend through one function), within 1e-5
    max abs of the plain version in fp32 and one bf16 ulp of the fp64
    formula in bf16 (at most 2e-3 of the outputs one off); 20 calls
    bit-equal."""
    b, h, w, c, groups, dtype = case
    args = _blend_mom_case(cuda, *case)
    assert mom_vec_plan(b, h * w, c, groups, dtype, _alignment(
        *(t.data_ptr() for t in args[:3])), True) is not None
    common.reset_launches()
    out = blend_from_moments(*args)
    assert (common.launches["gru_blend_mom_vec"],
            common.launches["gru_blend_mom_scalar"],
            common.launches["gru_blend_mom"]) == (1, 0, 1)
    scalar = blend_from_moments(*args, kernel="scalar")
    assert common.launches["gru_blend_mom_scalar"] == 1
    assert torch.equal(out, scalar)
    if dtype == torch.float32:
        assert _max_abs(out, _blend_mom_plain(*args)) <= 1e-5
    else:
        ulps, share = common.bf16_ulps(out, blend_f64(*args[:3],
                                                      *args[4:7]))
        assert ulps <= K34_BF16_ULPS and share <= K34_BF16_SHARE
    for _ in range(20):
        assert torch.equal(out, blend_from_moments(*args))


# The moments pass: (B, H, W, Ct, groups, dtype). A 'space' rank's gates
# (2C 128, G 4) and candidate (C 64, G 2) of the flagship, a ragged 8 x
# 13 map, groups of 32 channels over 96, narrow channels (Ct 16, G 1),
# and a 16 x 32 map whose samples the plan splits over a cluster (4
# blocks in bf16, 8 in fp32); fp32 and bf16.
MOMENTS_CASES = [(b, h, w, ct, g, dtype)
                 for b, h, w, ct, g in ((4, 8, 16, 128, 4),
                                        (4, 8, 16, 64, 2),
                                        (2, 8, 13, 128, 4),
                                        (3, 8, 13, 96, 3), (3, 5, 7, 16, 1),
                                        (2, 16, 32, 128, 4))
                 for dtype in DTYPES]


def _moments_f64(x, groups):
    b, h, w, ct = x.shape
    xd = x.double().reshape(b, h * w, groups, ct // groups)
    return torch.stack([xd.sum(dim=(1, 3)), (xd * xd).sum(dim=(1, 3))], -1)


def _of_largest_sum(mom, ref):
    return _max_abs(mom, ref) / ref.double().abs().max().item()


@pytest.mark.parametrize("case", MOMENTS_CASES,
                         ids=lambda c: "{}x{}x{}x{}-g{}-{}".format(
                             *c[:5], str(c[5])[6:]))
def test_moments_vec_matches_plain_and_fp64(cuda, case):
    """The rule takes the vector moments pass (a cluster of blocks where
    the plan says); within 1e-5 of the largest sum of the plain version
    and of the fp64 sums, as the scalar kernel is; 20 calls bit-equal."""
    b, h, w, ct, groups, dtype = case
    x = _rnd(cuda, b, h, w, ct, dtype=dtype)
    plan = moments_plan(b, h * w, ct, groups, dtype,
                        _alignment(x.data_ptr()))
    assert plan is not None
    if (h, w) == (16, 32):
        assert plan.ranks > 1
    common.reset_launches()
    mom = gru_moments(x, groups)
    assert (common.launches["gru_moments_vec"],
            common.launches["gru_moments_scalar"],
            common.launches["gru_moments"]) == (1, 0, 1)
    scalar = gru_moments(x, groups, kernel="scalar")
    assert common.launches["gru_moments_scalar"] == 1
    for ref in (gru_moments_plain(x, groups), _moments_f64(x, groups)):
        assert _of_largest_sum(mom, ref) <= 1e-5
        assert _of_largest_sum(scalar, ref) <= 1e-5
    for _ in range(20):
        assert torch.equal(mom, gru_moments(x, groups))


@pytest.mark.parametrize("refused", ["group_vectors", "misaligned",
                                     "narrow"])
def test_refused_moments_and_k4_shapes_take_the_scalar_kernels(cuda,
                                                               refused):
    """bf16 groups of 20 channels (40 bytes), a view one element into its
    storage, bf16 channels of 4 (8 bytes): the rules name the scalar
    moments pass and K4, which match the plain version and the fp64
    formula; asking for a vector kernel raises."""
    shape = {"group_vectors": (2, 5, 7, 40, 2), "misaligned": (2, 8, 16, 64, 2),
             "narrow": (2, 5, 7, 4, 1)}[refused]
    args = _blend_mom_case(cuda, *shape, torch.bfloat16)
    if refused == "misaligned":
        args = (_shifted(args[0]), *args[1:])
    cand, groups = args[0], args[6]
    common.reset_launches()
    mom = gru_moments(cand, groups)
    out = blend_from_moments(*args[:3], mom, *args[4:])
    assert (common.launches["gru_moments_vec"],
            common.launches["gru_moments_scalar"],
            common.launches["gru_blend_mom_vec"],
            common.launches["gru_blend_mom_scalar"]) == (0, 1, 0, 1)
    with pytest.raises(ValueError, match="vector kernel"):
        gru_moments(cand, groups, kernel="vec")
    with pytest.raises(ValueError, match="vector kernel"):
        blend_from_moments(*args, kernel="vec")
    assert _of_largest_sum(mom, _moments_f64(cand, groups)) <= 1e-5
    ulps, share = common.bf16_ulps(out, blend_f64(*args[:3], *args[4:7]))
    assert ulps <= K34_BF16_ULPS and share <= K34_BF16_SHARE


# (B, H, W, C, max_displacement, stride): ragged C, H != W, stride 1,
# d > H, every window overlapping (d <= H/2, stride 1), the FlowNetC bench
# geometry, the FlyingChairs feature shape, then the SIMT K5 and K7's
# shapes: the highres trainer's maps at B=2, odd maps with C = 40 (parity
# classes of 21 and 20 rows, 29 and 28 columns), and the S3VAE label
# features.
CORR_SIMT_SHAPES = [(2, 40, 56, 256, 20, 2), (2, 41, 57, 40, 20, 2),
                    (156, 8, 8, 256, 20, 2)]
CORR_SHAPES = [(2, 5, 7, 19, 2, 1), (3, 6, 4, 40, 3, 2), (2, 3, 5, 33, 4, 1),
               (1, 8, 8, 16, 4, 1), (2, 8, 8, 256, 20, 2),
               (2, 48, 64, 256, 20, 2), *CORR_SIMT_SHAPES]


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
        if _takes_tc(f1, f2, d, stride):  # tensor-core K6, K7: another order
            assert _rel_l2(outs[1], refs[1]) <= 1e-4
            assert _rel_l2(outs[2], refs[2]) <= 1e-4
        else:
            assert torch.equal(outs[1], refs[1])
            assert torch.equal(outs[2], refs[2])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CORR_SHAPES)
def test_simt_correlation_kernels_match_plain(cuda, shape, dtype):
    """The SIMT K5 and K7 at every shape, whatever the rule says (in bf16
    the bench geometry and the label features would take the tensor
    cores): one launch each under the wrappers' counters, fp32 within 1e-5
    of fp64, bf16 K5 within 1e-4 relative L2 and K7 bit-equal to the bf16
    plain versions."""
    f1, f2, g, d, stride = _corr_inputs(cuda, shape, dtype)
    common.reset_launches()
    fwd = _correlation_fwd_simt(f1, f2, d, stride)
    gf2 = _correlation_bwd_f2_simt(g, f1, d, stride)
    torch.cuda.synchronize()
    assert common.launches["correlation_fwd"] == 1
    assert common.launches["correlation_bwd_f2"] == 1
    assert common.launches["correlation_fwd_tc"] == 0
    assert common.launches["correlation_bwd_f2_tc"] == 0
    if dtype == torch.float32:
        a, b, gg = (t.double() for t in (f1, f2, g))
        assert _max_abs(fwd, correlation_fwd_plain(a, b, d, stride)) <= 1e-5
        assert _max_abs(gf2, correlation_bwd_f2_plain(gg, a, d,
                                                      stride)) <= 1e-5
    else:
        assert _rel_l2(fwd, correlation_fwd_plain(f1, f2, d, stride)) <= 1e-4
        assert torch.equal(gf2, correlation_bwd_f2_plain(g, f1, d, stride))


@pytest.mark.parametrize("dtype", DTYPES)
def test_simt_correlation_is_bit_reproducible(cuda, dtype):
    """20 calls of the SIMT K5 and K7 at the highres trainer's maps (B=2)
    give the same bits: one fixed order of summation, no atomics."""
    f1, f2, g, d, stride = _corr_inputs(cuda, (2, 40, 56, 256, 20, 2), dtype)
    fwd = _correlation_fwd_simt(f1, f2, d, stride)
    gf2 = _correlation_bwd_f2_simt(g, f1, d, stride)
    for _ in range(20):
        assert torch.equal(fwd, _correlation_fwd_simt(f1, f2, d, stride))
        assert torch.equal(gf2, _correlation_bwd_f2_simt(g, f1, d, stride))


# The SIMT K6's shapes: every correlation shape, and maps where cells
# meet no partner in the map (d = 3, stride 2 on one row: the pair view on
# a 1x1 map, the tiles on a 1x80 one), whose gradients are zeros.
K6_SHAPES = [*CORR_SHAPES, (2, 1, 1, 8, 3, 2), (2, 1, 80, 8, 3, 2)]


def _check_k6(gf1, g, f2, d, stride, dtype):
    """The SIMT K6 against its plain version and fp64: fp32 1e-5 max abs
    to both; bf16 bit-equal to the bf16 plain version and within one bf16
    ulp of fp64 (at most 1e-3 of the outputs one ulp off)."""
    ref64 = correlation_bwd_f1_plain(g.double(), f2.double(), d, stride)
    plain = correlation_bwd_f1_plain(g, f2, d, stride)
    assert gf1.dtype == dtype and gf1.shape == f2.shape
    if dtype == torch.float32:
        assert _max_abs(gf1, ref64) <= 1e-5
        assert _max_abs(gf1, plain) <= 1e-5
    else:
        assert torch.equal(gf1, plain)
        ulps, share = common.bf16_ulps(gf1, ref64)
        assert ulps <= CORR_BF16_ULPS and share <= CORR_BF16_SHARE


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", K6_SHAPES)
def test_simt_k6_matches_plain_and_fp64(cuda, shape, dtype):
    """The SIMT K6 forced at every shape: one launch, of the tile kernel or
    (maps of at most 32 cells a class) of the pair view as simt_plan says,
    none on the tensor cores; held as ``_check_k6`` says, and 20 calls
    bit-equal to the first."""
    f1, f2, g, d, stride = _corr_inputs(cuda, shape, dtype)
    plan = simt_plan(*f2.shape, d, stride, dtype)["correlation_bwd_f1"]
    common.reset_launches()
    gf1 = _correlation_bwd_f1_simt(g, f2, d, stride)
    torch.cuda.synchronize()
    assert common.launches["correlation_bwd_f1"] == 1
    assert common.launches["correlation_bwd_f1_tc"] == 0
    assert common.launches["correlation_bwd_f1_pairs"] == int(
        plan.kernel == "pairs")
    _check_k6(gf1, g, f2, d, stride, dtype)
    if shape[1] == 1:
        assert torch.equal(gf1, torch.zeros_like(gf1))
    for _ in range(20):
        assert torch.equal(gf1, _correlation_bwd_f1_simt(g, f2, d, stride))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", ["g", "f2", "both"])
@pytest.mark.parametrize("shape", [(2, 40, 56, 256, 20, 2),
                                   (2, 8, 8, 256, 20, 2),
                                   (2, 41, 57, 40, 20, 2)])
def test_simt_k6_at_misaligned_views(cuda, shape, which, dtype):
    """Views one element into their storage: the tile kernel and the pair
    view without 16-byte copies (f2) or with g read at any offset, held as
    at aligned pointers."""
    f1, f2, g, d, stride = _corr_inputs(cuda, shape, dtype)
    if which in ("g", "both"):
        g = _misaligned(g)
    if which in ("f2", "both"):
        f2 = _misaligned(f2)
    common.reset_launches()
    gf1 = _correlation_bwd_f1_simt(g, f2, d, stride)
    torch.cuda.synchronize()
    assert common.launches["correlation_bwd_f1"] == 1
    _check_k6(gf1, g, f2, d, stride, dtype)


def _takes_tc(f1, f2, d, stride) -> bool:
    _, h, w, c = f1.shape
    return tc_plan(h, w, c, d, stride, f1.dtype,
                   (f1.data_ptr(), f2.data_ptr()))


# Maps the tensor-core K5-K7 take (B, H, W, C, d, stride): the bench
# geometry (8x8x256, d = 20, stride 2), 8x8 at C = 64, H != W (4x16), an
# odd 7x7 map (samples' outputs straddle 16-byte units), stride 1 with
# d = 3, and stride 1 with d = 20 (1,681 displacements: K5's staged output
# near the most a block's shared memory holds).
CORR_TC_SHAPES = [(4, 8, 8, 256, 20, 2), (3, 8, 8, 64, 20, 2),
                  (3, 4, 16, 64, 20, 2), (3, 7, 7, 128, 20, 2),
                  (3, 8, 8, 64, 3, 1), (2, 8, 8, 64, 20, 1)]
# bf16 K5-K7 against fp64 of the same inputs: one ulp, at most this share
# one ulp off, as chip_smoke.py.
CORR_BF16_ULPS, CORR_BF16_SHARE = 1.0, 1e-3


@pytest.mark.parametrize("shape", CORR_TC_SHAPES)
def test_tensor_core_correlation_matches_simt_and_fp64(cuda, shape):
    """The rule sends bf16 K5-K7 at these maps to the tensor cores; the
    tensor-core kernels and the SIMT ones within one bf16 ulp of the fp64
    plain versions on the same inputs, the tensor-core kernels within 1e-4
    relative L2 of the bf16 plain versions. K6 reads the pair matrix M
    transposed, so a wrong descriptor for it shows at these non-square and
    ragged maps."""
    f1, f2, g, d, stride = _corr_inputs(cuda, shape, torch.bfloat16)
    assert _takes_tc(f1, f2, d, stride)
    common.reset_launches()
    fwd = correlation_fwd(f1, f2, d, stride)
    gf1 = correlation_bwd_f1(g, f2, d, stride)
    gf2 = correlation_bwd_f2(g, f1, d, stride)
    for name in ("correlation_fwd", "correlation_bwd_f1",
                 "correlation_bwd_f2"):
        assert common.launches[f"{name}_tc"] == 1
        assert common.launches[name] == 1
    assert torch.equal(fwd, _correlation_fwd_tc(f1, f2, d, stride))
    assert torch.equal(gf1, _correlation_bwd_f1_tc(g, f2, d, stride))
    assert torch.equal(gf2, _correlation_bwd_f2_tc(g, f1, d, stride))
    cases = ((fwd, _correlation_fwd_simt(f1, f2, d, stride),
              correlation_fwd_plain(f1.double(), f2.double(), d, stride),
              correlation_fwd_plain(f1, f2, d, stride)),
             (gf1, _correlation_bwd_f1_simt(g, f2, d, stride),
              correlation_bwd_f1_plain(g.double(), f2.double(), d, stride),
              correlation_bwd_f1_plain(g, f2, d, stride)),
             (gf2, _correlation_bwd_f2_simt(g, f1, d, stride),
              correlation_bwd_f2_plain(g.double(), f1.double(), d, stride),
              correlation_bwd_f2_plain(g, f1, d, stride)))
    torch.cuda.synchronize()
    for tc, simt, ref, plain in cases:
        assert tc.dtype == torch.bfloat16 and tc.shape == ref.shape
        for got in (tc, simt):
            ulps, share = common.bf16_ulps(got, ref)
            assert ulps <= CORR_BF16_ULPS and share <= CORR_BF16_SHARE
        assert _rel_l2(tc, plain) <= 1e-4


def test_tensor_core_correlation_is_bit_reproducible(cuda):
    f1, f2, g, d, stride = _corr_inputs(cuda, (16, 8, 8, 256, 20, 2),
                                        torch.bfloat16)
    fwd = _correlation_fwd_tc(f1, f2, d, stride)
    gf1 = _correlation_bwd_f1_tc(g, f2, d, stride)
    gf2 = _correlation_bwd_f2_tc(g, f1, d, stride)
    for _ in range(20):
        assert torch.equal(fwd, _correlation_fwd_tc(f1, f2, d, stride))
        assert torch.equal(gf1, _correlation_bwd_f1_tc(g, f2, d, stride))
        assert torch.equal(gf2, _correlation_bwd_f2_tc(g, f1, d, stride))


@pytest.mark.parametrize("refused", ["fp32", "chairs", "c48", "c192",
                                     "misaligned", "misaligned_f2"])
def test_refused_correlation_shapes_take_the_simt_kernels(cuda, refused):
    """fp32 at the bench geometry, the FlyingChairs feature map, C = 48 and
    C = 192 (no unrolled tensor-core kernel): the rule names the SIMT
    K5-K7. An f1 view one element into its storage sends K5 and K7 (which
    read f1) to SIMT and K6 (g, f2) still to the tensor cores; an f2 view,
    K5 and K6 to SIMT and K7 to the tensor cores. The SIMT kernels run and
    match the plain versions (fp32 1e-5 against fp64; bf16 K5 1e-4
    relative L2, K6 and K7 bit-equal), the tensor-core ones 1e-4 relative
    L2; the tensor-core wrappers of the refused calls raise; nothing is
    raised or caught on the way."""
    shape, dtype = {"fp32": ((2, 8, 8, 256, 20, 2), torch.float32),
                    "chairs": ((2, 48, 64, 256, 20, 2), torch.bfloat16),
                    "c48": ((2, 8, 8, 48, 20, 2), torch.bfloat16),
                    "c192": ((2, 8, 8, 192, 20, 2), torch.bfloat16),
                    "misaligned": ((2, 8, 8, 256, 20, 2), torch.bfloat16),
                    "misaligned_f2": ((2, 8, 8, 256, 20, 2),
                                      torch.bfloat16)}[refused]
    f1, f2, g, d, stride = _corr_inputs(cuda, shape, dtype)
    names = ("correlation_fwd", "correlation_bwd_f1", "correlation_bwd_f2")
    simt = names
    if refused == "misaligned":
        f1 = _misaligned(f1)
        simt = ("correlation_fwd", "correlation_bwd_f2")
    elif refused == "misaligned_f2":
        f2 = _misaligned(f2)
        simt = ("correlation_fwd", "correlation_bwd_f1")
    assert not _takes_tc(f1, f2, d, stride)
    common.reset_launches()
    outs = (correlation_fwd(f1, f2, d, stride),
            correlation_bwd_f1(g, f2, d, stride),
            correlation_bwd_f2(g, f1, d, stride))
    for name in names:
        assert common.launches[name] == 1
        assert common.launches[f"{name}_tc"] == int(name not in simt)
    tc_wrappers = {"correlation_fwd": lambda: _correlation_fwd_tc(
                       f1, f2, d, stride),
                   "correlation_bwd_f1": lambda: _correlation_bwd_f1_tc(
                       g, f2, d, stride),
                   "correlation_bwd_f2": lambda: _correlation_bwd_f2_tc(
                       g, f1, d, stride)}
    for name in simt:
        with pytest.raises(ValueError, match="tensor-core kernel's rule"):
            tc_wrappers[name]()
    ref_dtype = torch.float64 if dtype == torch.float32 else dtype
    a, b, gg = (t.to(ref_dtype) for t in (f1, f2, g))
    refs = (correlation_fwd_plain(a, b, d, stride),
            correlation_bwd_f1_plain(gg, b, d, stride),
            correlation_bwd_f2_plain(gg, a, d, stride))
    torch.cuda.synchronize()
    if dtype == torch.float32:
        for out, ref in zip(outs, refs):
            assert _max_abs(out, ref) <= 1e-5
    else:
        assert _rel_l2(outs[0], refs[0]) <= 1e-4
        for name, out, ref in zip(names[1:], outs[1:], refs[1:]):
            if name in simt:
                assert torch.equal(out, ref)
            else:
                assert _rel_l2(out, ref) <= 1e-4


def _misaligned(x, offset=1):
    """A contiguous copy of x that starts ``offset`` elements into its
    storage."""
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = flat[offset:].view(x.shape)
    view.copy_(x)
    return view


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("offset", [0, 2], ids=["aligned", "8-bytes-in"])
def test_channelnorm_is_bit_equal_to_plain_at_flownet2_maps(cuda, offset, c,
                                                            dtype):
    """K8 at FlowNet2's (8, 64, 64, C), exact-zero pixels included, and on
    a view two elements into its storage (the kernel reads by element):
    one launch, bit-equal to the plain version in fp32 and bf16."""
    x = _misaligned(_rnd(cuda, 8, 64, 64, c, dtype=dtype), offset)
    x[0, :3] = 0
    common.reset_launches()
    out = channelnorm_fwd(x)
    assert common.launches["channelnorm"] == 1
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (8, 64, 64, 1)
    assert torch.equal(out, channelnorm_plain(x))
    assert (out[0, :3] == 0).all()


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
    assert common.launches == {"conv3x3_fwd": 1, "conv3x3_fwd_tc": 0,
                               "conv3x3_fwd_simt": 1, "conv3x3_fwd_halo": 0,
                               "conv3x3_fwd_nt32": 0, "conv3x3_fwd_nt16": 0,
                               "conv3x3_wgrad": 1,
                               "conv3x3_wgrad_tc": 0,
                               "conv3x3_wgrad_simt": 1,
                               "conv3x3_wgrad_halo": 0,
                               "gru_gates": 1, "gru_gates_sample": 1,
                               "gru_gates_2pass": 0, "gru_blend": 1,
                               "gru_blend_sample": 1, "gru_blend_2pass": 0,
                               "gru_gates_mom": 0, "gru_gates_mom_vec": 0,
                               "gru_gates_mom_scalar": 0, "gru_blend_mom": 0,
                               "gru_blend_mom_vec": 0,
                               "gru_blend_mom_scalar": 0, "gru_moments": 0,
                               "gru_moments_vec": 0, "gru_moments_scalar": 0,
                               "correlation_fwd": 1, "correlation_fwd_tc": 0,
                               "correlation_fwd_pairs": 1,
                               "correlation_bwd_f1": 1,
                               "correlation_bwd_f1_tc": 0,
                               "correlation_bwd_f1_pairs": 1,
                               "correlation_bwd_f2": 1,
                               "correlation_bwd_f2_tc": 0,
                               "correlation_bwd_f2_pairs": 1,
                               "channelnorm": 1}
    with common.force_plain():
        conv3x3_fwd(x, _rnd(cuda, 72, 8))
    assert common.launches["conv3x3_fwd"] == 1
    conv3x3_fwd(*_tc_case(cuda, (1, 4, 4, 16, 16), False))
    assert common.launches["conv3x3_fwd"] == 2
    assert common.launches["conv3x3_fwd_tc"] == 1
    xb = _rnd(cuda, 1, 4, 4, 64, dtype=torch.bfloat16)
    conv3x3_wgrad(xb, xb)
    assert common.launches["conv3x3_wgrad"] == 2
    assert common.launches["conv3x3_wgrad_tc"] == 1
    gb = _rnd(cuda, 1, 4, 4, 9, dtype=torch.bfloat16)
    correlation_fwd(xb, xb, 1, 1)
    correlation_bwd_f1(gb, xb, 1, 1)
    correlation_bwd_f2(gb, xb, 1, 1)
    for name in ("correlation_fwd", "correlation_bwd_f1",
                 "correlation_bwd_f2"):
        assert common.launches[name] == 2
        assert common.launches[f"{name}_tc"] == 1


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


@pytest.mark.parametrize("block", [
    "train_mmnist_cgru_len20", "train_mmnist_cgrudecODE",
    "train_mmnist_odecgrumem_len20_1ch", "train_mmnist_odecgrumem2_len20_1ch",
    "train_mmnist_sample_odecgru"])
def test_recurrent_step_matches_plain(cuda, block):
    cfg = load_config(["defaults", block], overrides={
        "batch_size": 4, "train_in_seq": 10, "train_out_seq": 10})
    model = create_train_state(cfg, torch.device("cuda")).model
    bank = torch.from_numpy(get_sprite_bank(cfg.data_dir)).float().cuda()
    video = generate_moving_mnist(torch.Generator(device="cuda").manual_seed(
        2), bank, batch=4, n_frames=20, num_digits=3)
    batch = make_batch_dict(video, 10)

    def run():
        gen = torch.Generator(device="cuda").manual_seed(7)
        metrics, pred = loss_and_grads(model, batch, gen)
        return metrics, pred, {n: p.grad.clone()
                               for n, p in model.named_parameters()}

    def compare(leaves):
        common.reset_launches()
        m_k, pred_k, g_k = run()
        counts = dict(common.launches)
        with common.force_plain():
            m_p, pred_p, g_p = run()
        for k in ("nfe", "ode_accepted", "ode_rejected", "ode_converged"):
            assert m_k.get(k) == m_p.get(k), k
        assert abs(float(m_k["loss"]) / float(m_p["loss"]) - 1.0) <= 1e-5
        assert _max_abs(pred_k, pred_p) <= 1e-4
        for name in filter(leaves, g_k):
            err = ((g_k[name] - g_p[name]).norm()
                   / g_p[name].norm().clamp_min(1e-30)).item()
            assert err <= 1e-3, name
        return counts

    if cfg.z_sample:
        assert model.z_kl_weight > 0
        compare(lambda name: not name.startswith(("conv_encoder.",
                                                  "z0_encoder.")))
        model.z_kl_weight = 0.0
    counts = compare(lambda name: True)
    assert counts["gru_gates"] > 0 and counts["gru_blend"] > 0
    assert counts["gru_gates_sample"] == counts["gru_gates"]
    assert counts["gru_blend_sample"] == counts["gru_blend"]
    if cfg.model == "ConvGRU":
        assert counts["conv3x3_fwd"] == counts["conv3x3_wgrad"] == 0
    else:
        assert counts["conv3x3_fwd"] > 0 and counts["conv3x3_wgrad"] > 0
        assert counts["conv3x3_fwd_simt"] == counts["conv3x3_fwd"]
        assert counts["conv3x3_wgrad_simt"] == counts["conv3x3_wgrad"]


@pytest.mark.parametrize("block", [
    "train_mmnist_recon_cs3vae", "train_mmnist_s3vae_odecgru",
    "train_mmnist_recon_cs4vae"])
def test_s3vae_step_matches_plain(cuda, block):
    """One S3VAE step at B=4, fp32, 64x64, 20 -> 20 frames through the
    kernels against the same step under ``force_plain()``: the same
    weights, BatchNorm buffers, batch and noise. Loss 1e-5 relative,
    prediction 1e-4 max abs, every gradient leaf within 1e-3 of its norm
    plus 1e-5 of the whole norm (the biases of the convs before a
    training-mode BatchNorm have no gradient in exact arithmetic), the
    BatchNorm buffers after the step 1e-5 relative L2, equal NFE."""
    from ode_rl_torch.nn import s3vae_nets

    cfg = load_config(["defaults", block])
    model = create_train_state(cfg, torch.device("cuda")).model
    bank = torch.from_numpy(get_sprite_bank(cfg.data_dir)).float().cuda()
    video = generate_moving_mnist(torch.Generator(device="cuda").manual_seed(
        2), bank, batch=4, n_frames=40, num_digits=3)
    batch = make_batch_dict(video, 20, with_flow_labels=True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    real = s3vae_nets.odeint_aux

    def run():
        nfe = []

        def solve(*args, **kwargs):
            ys, stats = real(*args, **kwargs)
            nfe.append(stats.nfe)
            return ys, stats

        model.load_state_dict(start)
        s3vae_nets.odeint_aux = solve
        try:
            gen = torch.Generator(device="cuda").manual_seed(7)
            metrics, pred = loss_and_grads(model, batch, gen)
        finally:
            s3vae_nets.odeint_aux = real
        return (metrics, pred,
                {n: p.grad.clone() for n, p in model.named_parameters()},
                {n: b.clone() for n, b in model.named_buffers()}, nfe)

    common.reset_launches()
    m_k, pred_k, g_k, b_k, nfe_k = run()
    counts = dict(common.launches)
    with common.force_plain():
        m_p, pred_p, g_p, b_p, nfe_p = run()
    assert nfe_k == nfe_p
    assert abs(float(m_k["loss"]) / float(m_p["loss"]) - 1.0) <= 1e-5
    assert _max_abs(pred_k, pred_p) <= 1e-4
    total = torch.sqrt(sum(torch.sum(g.double() ** 2)
                           for g in g_p.values())).item()
    for name in g_k:
        err = (g_k[name] - g_p[name]).double().norm().item()
        assert err <= 1e-3 * g_p[name].double().norm().item() + 1e-5 * total, \
            name
    for name in b_k:
        assert ((b_k[name] - b_p[name]).norm()
                / b_p[name].norm().clamp_min(1e-30)).item() <= 1e-5, name
    assert counts["gru_gates"] > 0 and counts["gru_blend"] > 0
    assert counts["gru_gates_sample"] == counts["gru_gates"]
    assert counts["gru_blend_sample"] == counts["gru_blend"]
    if cfg.encoder == "odecgru":
        assert nfe_k and counts["conv3x3_fwd"] > 0
        assert counts["conv3x3_fwd_simt"] == counts["conv3x3_fwd"]
        assert counts["conv3x3_wgrad_simt"] == counts["conv3x3_wgrad"] > 0
    else:
        assert counts["conv3x3_fwd"] == counts["conv3x3_wgrad"] == 0


@pytest.mark.parametrize("cin,cout", [(32, 64), (128, 64), (64, 32),
                                      (64, 128)])
def test_simt_conv_at_s3vae_maps(cuda, cin, cout):
    """K1 (forward and as dx) and K2 on S3VAE's 4x4 maps at B=4, fp32,
    through the SIMT kernels, against the fp64 conv."""
    gen = torch.Generator().manual_seed(cin + cout)
    x = torch.randn(4, 4, 4, cin, generator=gen).cuda()
    g = torch.randn(4, 4, 4, cout, generator=gen).cuda()
    w = (torch.randn(9 * cin, cout, generator=gen) / (3 * cin ** 0.5)).cuda()
    common.reset_launches()
    y = conv3x3_fwd(x, w)
    dx = conv3x3_fwd(g, flip_transpose(w, cin, cout))
    dw = conv3x3_wgrad(x, g)
    assert common.launches["conv3x3_fwd_simt"] == 2
    assert common.launches["conv3x3_wgrad_simt"] == 1
    assert _max_abs(y, conv3x3_fwd_plain(x.double(), w.double())) <= 1e-4
    assert _max_abs(dx, conv3x3_fwd_plain(
        g.double(), flip_transpose(w, cin, cout).double())) <= 1e-4
    ref = conv3x3_wgrad_plain(x.double(), g.double())
    assert ((dw.double() - ref).norm() / ref.norm()).item() <= 1e-5


@pytest.mark.parametrize("b,hw,c", [(12, 4, 64), (12, 8, 256), (4, 4, 128),
                                    (4, 8, 32)])
def test_gru_tails_at_s3vae_shapes(cuda, b, hw, c):
    """K3 and K4 at S3VAE's ConvGRU shapes (3B rows of the static heads,
    4x4 and 8x8 maps, the 'odecgru' z0 cell), fp32, through their
    one-sample kernels, against the plain versions (1e-5 max abs)."""
    gen = torch.Generator().manual_seed(b * hw + c)
    rnd = lambda *s: torch.randn(*s, generator=gen).cuda()
    h = torch.tanh(rnd(b, hw, hw, c))
    gates, cand = rnd(b, hw, hw, 2 * c), rnd(b, hw, hw, c)
    z = torch.sigmoid(rnd(b, hw, hw, c))
    gs, gb, cs, cb = (1.0 + 0.1 * rnd(2 * c), 0.1 * rnd(2 * c),
                      1.0 + 0.1 * rnd(c), 0.1 * rnd(c))
    gg, gc = max(2 * c // 32, 1), max(c // 32, 1)
    common.reset_launches()
    zk, rhk = fused_gru_gates(gates, h, gs, gb, gg)
    out = fused_gru_blend(cand, z, h, cs, cb, gc)
    assert common.launches["gru_gates_sample"] == 1
    assert common.launches["gru_blend_sample"] == 1
    zp, rhp = _gates_plain(gates, h, gs, gb, gg)
    assert _max_abs(zk, zp) <= 1e-5 and _max_abs(rhk, rhp) <= 1e-5
    assert _max_abs(out, _blend_plain(cand, z, h, cs, cb, gc)) <= 1e-5
