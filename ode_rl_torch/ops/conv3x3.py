"""3x3 stride-1 SAME conv of the ODE field: kernels K1 and K2.

Counterpart of ``ode_rl_tpu/ops/conv3x3.py``. NHWC x HWIO -> NHWC, with
the weights handed to the kernels as ``kernel.reshape(9 * Cin, Cout)``.

* K1 ``conv3x3_fwd`` (``csrc/conv3x3.cu``): the implicit-im2col GEMM,
  fp32 accumulation, output in the input dtype. Its plain version is
  ``F.conv2d``. On the card it takes one of two kernels by
  ``uses_tensor_cores``: the tensor-core kernel (bf16; TMA halo tiles,
  weights resident in shared memory, wgmma) or the SIMT kernel (fp32 FMA;
  everything else, fp32 included, so fp32 stays strict fp32).
* K2 ``conv3x3_wgrad``: dW (9*Cin, Cout) = patches^T . g in fp32, split
  over pixels with a fixed-order reduction. Its plain version builds the 9
  shifted patches, as the Pallas kernel does, and multiplies. On the card
  it takes one of two kernels by ``wgrad_uses_tensor_cores``: the
  tensor-core kernel (bf16, channels in multiples of 64; TMA halo and
  cotangent tiles, wgmma over pixels, one cooperative launch that sums its
  partials after a grid sync) or the SIMT kernel (everything else,
  fp32 included; a partial pass and a sum pass).

``Conv3x3Fn`` has the backward of ``_conv3x3_bwd``: dx is K1 on the
cotangent with spatially flipped, channel-transposed weights, dw is K2
cast to the weight dtype. The bias is added outside, in the input dtype.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ode_rl_torch.ops import common
from ode_rl_torch.ops._build import library

# K2 split-K: about this many rows of B*H*W per split, at most _MAX_SPLITS.
_ROWS_PER_SPLIT = 1024
_MAX_SPLITS = 128


def _shape_nhwc(name: str, x: torch.Tensor) -> tuple[int, int, int, int]:
    if x.ndim != 4:
        raise ValueError(f"{name}: expected NHWC (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    return tuple(x.shape)


def conv3x3_fwd_plain(x: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    b, h, w, cin = x.shape
    cout = w2d.shape[1]
    w_oihw = w2d.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    out = F.conv2d(x.permute(0, 3, 1, 2), w_oihw.to(x.dtype), padding=1)
    return out.permute(0, 2, 3, 1).contiguous()


# The tensor-core K1: output tiles 8 rows high of one image, and the
# shared memory a block may have on the H100 less 64 bytes for the kernel's
# static barriers. Mirrors csrc/conv3x3.cu::tc_plan.
_TC_TILE_ROWS = 8
_TC_SMEM_LIMIT = 232_448 - 64


def _round_1k(n: int) -> int:
    return -(-n // 1024) * 1024


def _tc_tile_width(w: int) -> int:
    """Width of an output tile: the image's width rounded up to 8, 16 or
    32 (a 16-wide map is tiled 8 x 16)."""
    return 8 if w <= 8 else 16 if w <= 16 else 32


def _tc_smem_bytes(cin: int, cout: int, w: int) -> int:
    """Shared memory of one tensor-core K1 block: the weights in column
    blocks of 64 (or 16) channels, two halo stages in channel chunks of 64,
    32 or 16, two 8 x 8 output staging buffers, each region 1 KB aligned,
    and 1 KB to align the base."""
    tw = _tc_tile_width(w)
    nt = 64 if cout % 64 == 0 else 16
    cw = 64 if cin % 64 == 0 else 32 if cin % 32 == 0 else 16
    weights = (cout // nt) * _round_1k(9 * cin * nt * 2)
    stage = (cin // cw) * _round_1k((_TC_TILE_ROWS + 2) * (tw + 2) * cw * 2)
    staging = _round_1k(64 * nt * 2)
    return weights + 2 * stage + 2 * staging + 1024


def uses_tensor_cores(dtype: torch.dtype, cin: int, cout: int,
                      w: int) -> bool:
    """The rule that sends a K1 call on the card to the tensor-core kernel:
    bf16, Cin % 16 == 0 (a k16 step, and TMA's 16-byte strides), Cout % 16
    == 0 and Cout <= 256 (wgmma's N), and the resident weights, two halo
    stages and the output staging within a block's shared memory (so the
    rule depends on W through the tile width). Every other call takes the
    SIMT kernel. fp32 stays on SIMT: the tensor cores would round it to
    TF32."""
    return (dtype == torch.bfloat16 and cin % 16 == 0 and cout % 16 == 0
            and cout <= 256
            and _tc_smem_bytes(cin, cout, w) <= _TC_SMEM_LIMIT)


def _check_k1(x: torch.Tensor, w2d: torch.Tensor) -> tuple:
    b, h, w, cin = _shape_nhwc("conv3x3_fwd", x)
    if w2d.ndim != 2 or w2d.shape[0] != 9 * cin:
        raise ValueError(f"conv3x3_fwd: weights {tuple(w2d.shape)} do not "
                         f"match (9*{cin}, Cout)")
    return b, h, w, cin, w2d.shape[1]


def conv3x3_fwd(x: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """K1: (B, H, W, Cin) . (9*Cin, Cout) -> (B, H, W, Cout), x's dtype."""
    _, _, w, cin, cout = _check_k1(x, w2d)
    if not common.use_kernel(x):
        return conv3x3_fwd_plain(x, w2d)
    common.check_inputs("conv3x3_fwd", {"x": x, "w": w2d}, x.dtype)
    if uses_tensor_cores(x.dtype, cin, cout, w):
        return _launch_tc(x, w2d)
    return _launch_simt(x, w2d)


def _conv3x3_fwd_simt(x: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """K1's SIMT kernel on CUDA tensors, whatever the rule says (the card
    tests and chip_smoke.py hold the two K1 kernels against each other)."""
    _check_k1(x, w2d)
    common.check_inputs("conv3x3_fwd", {"x": x, "w": w2d}, x.dtype)
    return _launch_simt(x, w2d)


def _conv3x3_fwd_tc(x: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """K1's tensor-core kernel on CUDA tensors; raises outside its rule."""
    _, _, w, cin, cout = _check_k1(x, w2d)
    common.check_inputs("conv3x3_fwd", {"x": x, "w": w2d}, x.dtype)
    if not uses_tensor_cores(x.dtype, cin, cout, w):
        raise ValueError(f"conv3x3_fwd: {x.dtype}, Cin {cin}, Cout {cout}, "
                         f"W {w} is outside the tensor-core kernel's rule")
    return _launch_tc(x, w2d)


def _launch_simt(x: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    b, h, w, cin = x.shape
    cout = w2d.shape[1]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    common.launch("conv3x3_fwd", library().odek_conv3x3_fwd,
                  x.data_ptr(), w2d.data_ptr(), out.data_ptr(), b, h, w, cin,
                  cout, common.DTYPE_CODES[x.dtype], common.stream_handle(x))
    return out


def _launch_tc(x: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """Raises on a pointer that is not 16-byte aligned (TMA's rule): a
    view into a larger tensor, for example, rather than rerouting it."""
    for arg, t in (("x", x), ("w", w2d)):
        if t.data_ptr() % 16:
            raise ValueError(f"conv3x3_fwd: {arg} is not 16-byte aligned "
                             f"(TMA needs it); pass a fresh tensor")
    b, h, w, cin = x.shape
    cout = w2d.shape[1]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    common.launch("conv3x3_fwd_tc", library().odek_conv3x3_fwd_tc,
                  x.data_ptr(), w2d.data_ptr(), out.data_ptr(), b, h, w, cin,
                  cout, _tc_tile_width(w), common.DTYPE_CODES[x.dtype],
                  common.stream_handle(x))
    common.launches["conv3x3_fwd"] += 1
    return out


def conv3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """patches^T . g in fp32 (fp64 for fp64 inputs, a reference)."""
    b, h, w, cin = x.shape
    cout = g.shape[3]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    g2 = g.reshape(b * h * w, cout).to(acc)
    cols = [xp[:, dy:dy + h, dx:dx + w, :].reshape(b * h * w, cin).to(acc)
            for dy in range(3) for dx in range(3)]
    return torch.cat([c.T @ g2 for c in cols], dim=0)


# The tensor-core K2 (csrc/conv3x3.cu::conv3x3_wgrad_tc_kernel): a block
# owns one tap row of one 64 x 64 channel pair of dW and a run of tiles; at
# most this many pairs, so that every (pair, row) gets a block on any
# Hopper card (the H100 PCIe has 114 SMs).
_WGRAD_TC_MAX_PAIRS = 32


def wgrad_uses_tensor_cores(dtype: torch.dtype, cin: int, cout: int,
                            w: int) -> bool:
    """The rule that sends a K2 call on the card to the tensor-core kernel:
    bf16, Cin % 64 == 0 and Cout % 64 == 0 (a block's wgmma is 64 input by
    64 output channels, each a 128-byte swizzle row of its tile), and at
    most _WGRAD_TC_MAX_PAIRS such channel pairs (each needs three resident
    blocks). Its shared memory fits at every width (the stages of 8 x 32
    tiles take the most, 231,424 bytes), so W does not enter. Every other
    call takes the SIMT kernel; fp32 stays on SIMT, so it stays strict
    fp32."""
    del w  # the tile width changes the plan, not the rule
    return (dtype == torch.bfloat16 and cin % 64 == 0 and cout % 64 == 0
            and (cin // 64) * (cout // 64) <= _WGRAD_TC_MAX_PAIRS)


@functools.lru_cache(maxsize=256)
def wgrad_tc_plan(b: int, h: int, w: int, cin: int, cout: int,
                  sms: int) -> tuple[int, int, int]:
    """(tile width, splits S, tiles per split T) of a tensor-core K2 call:
    the tiles (8 rows by TW pixels of one image, in order of image, tile
    row, tile column) go to S splits in runs of T, run s = [s*T, (s+1)*T),
    with no split empty; 3 * channel pairs * S blocks, at most ``sms``."""
    tw = _tc_tile_width(w)
    tiles = b * -(-h // _TC_TILE_ROWS) * -(-w // tw)
    cap = max(1, sms // (3 * (cin // 64) * (cout // 64)))
    per = -(-tiles // min(tiles, cap))
    return tw, -(-tiles // per), per


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_k2(x: torch.Tensor, g: torch.Tensor) -> tuple:
    b, h, w, cin = _shape_nhwc("conv3x3_wgrad", x)
    gb, gh, gw, cout = _shape_nhwc("conv3x3_wgrad", g)
    if (gb, gh, gw) != (b, h, w):
        raise ValueError(f"conv3x3_wgrad: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} differ in (B, H, W)")
    return b, h, w, cin, cout


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K2: input (B, H, W, Cin), cotangent (B, H, W, Cout) -> dW
    (9*Cin, Cout) in fp32."""
    _, _, w, cin, cout = _check_k2(x, g)
    if not common.use_kernel(x):
        return conv3x3_wgrad_plain(x, g)
    common.check_inputs("conv3x3_wgrad", {"x": x, "g": g}, x.dtype)
    if wgrad_uses_tensor_cores(x.dtype, cin, cout, w):
        return _launch_wgrad_tc(x, g)
    return _launch_wgrad_simt(x, g)


def _conv3x3_wgrad_simt(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K2's SIMT kernel on CUDA tensors, whatever the rule says."""
    _check_k2(x, g)
    common.check_inputs("conv3x3_wgrad", {"x": x, "g": g}, x.dtype)
    return _launch_wgrad_simt(x, g)


def _conv3x3_wgrad_tc(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K2's tensor-core kernel on CUDA tensors; raises outside its rule."""
    _, _, w, cin, cout = _check_k2(x, g)
    common.check_inputs("conv3x3_wgrad", {"x": x, "g": g}, x.dtype)
    if not wgrad_uses_tensor_cores(x.dtype, cin, cout, w):
        raise ValueError(f"conv3x3_wgrad: {x.dtype}, Cin {cin}, Cout {cout}, "
                         f"W {w} is outside the tensor-core kernel's rule")
    return _launch_wgrad_tc(x, g)


def _launch_wgrad_tc(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Raises on a pointer that is not 16-byte aligned (TMA's rule)."""
    for arg, t in (("x", x), ("g", g)):
        if t.data_ptr() % 16:
            raise ValueError(f"conv3x3_wgrad: {arg} is not 16-byte aligned "
                             f"(TMA needs it); pass a fresh tensor")
    b, h, w, cin = x.shape
    cout = g.shape[3]
    tw, splits, per = wgrad_tc_plan(b, h, w, cin, cout, _sm_count(x.device))
    scratch = torch.empty((splits, 9 * cin, cout), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((9 * cin, cout), dtype=torch.float32, device=x.device)
    common.launch("conv3x3_wgrad_tc", library().odek_conv3x3_wgrad_tc,
                  x.data_ptr(), g.data_ptr(), scratch.data_ptr(),
                  dw.data_ptr(), b, h, w, cin, cout, tw, splits, per,
                  common.DTYPE_CODES[x.dtype], common.stream_handle(x))
    common.launches["conv3x3_wgrad"] += 1
    return dw


def _launch_wgrad_simt(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    b, h, w, cin = x.shape
    cout = g.shape[3]
    rows = b * h * w
    splits = min(_MAX_SPLITS, -(-rows // _ROWS_PER_SPLIT))
    rows_per_split = -(-rows // splits)
    scratch = torch.empty((splits, 9 * cin, cout), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((9 * cin, cout), dtype=torch.float32, device=x.device)
    common.launch("conv3x3_wgrad", library().odek_conv3x3_wgrad,
                  x.data_ptr(), g.data_ptr(), scratch.data_ptr(),
                  dw.data_ptr(), b, h, w, cin, cout, splits, rows_per_split,
                  common.DTYPE_CODES[x.dtype], common.stream_handle(x))
    return dw


def flip_transpose(w2d: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """(9*Cin, Cout) -> (9*Cout, Cin): the spatially flipped,
    channel-transposed weights that turn the forward conv into dx."""
    w4d = w2d.reshape(3, 3, cin, cout)
    return torch.flip(w4d, dims=(0, 1)).permute(0, 1, 3, 2).reshape(
        9 * cout, cin).contiguous()


class Conv3x3Fn(torch.autograd.Function):
    """K1 forward; backward dx = K1 with flipped weights, dw = K2."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w2d)
        return conv3x3_fwd(x, w2d)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w2d = ctx.saved_tensors
        g = g.contiguous()
        cin, cout = x.shape[3], w2d.shape[1]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_fwd(g, flip_transpose(w2d, cin, cout)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad(x, g).to(w2d.dtype)
        return dx, dw


def conv3x3_same(x: torch.Tensor, kernel: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 stride-1 SAME conv, NHWC x HWIO -> NHWC; the bias is added in
    the input dtype, as ``nn.Conv`` does."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    out = Conv3x3Fn.apply(x, kernel.reshape(9 * cin, cout))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
