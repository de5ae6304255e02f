"""3x3 stride-1 SAME conv of the ODE field: kernels K1 and K2.

Counterpart of ``ode_rl_tpu/ops/conv3x3.py``. NHWC x HWIO -> NHWC, with
the weights handed to the kernels as ``kernel.reshape(9 * Cin, Cout)``.

* K1 ``conv3x3_fwd`` (``csrc/conv3x3.cu``): the implicit-im2col GEMM,
  fp32 accumulation, output in the input dtype. Its plain version is
  ``F.conv2d``.
* K2 ``conv3x3_wgrad``: dW (9*Cin, Cout) = patches^T . g in fp32, split-K
  with a fixed-order reduction. Its plain version builds the 9 shifted
  patches, as the Pallas kernel does, and multiplies.

``Conv3x3Fn`` has the backward of ``_conv3x3_bwd``: dx is K1 on the
cotangent with spatially flipped, channel-transposed weights, dw is K2
cast to the weight dtype. The bias is added outside, in the input dtype.
"""

from __future__ import annotations

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


def conv3x3_fwd(x: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """K1: (B, H, W, Cin) . (9*Cin, Cout) -> (B, H, W, Cout), x's dtype."""
    b, h, w, cin = _shape_nhwc("conv3x3_fwd", x)
    if w2d.ndim != 2 or w2d.shape[0] != 9 * cin:
        raise ValueError(f"conv3x3_fwd: weights {tuple(w2d.shape)} do not "
                         f"match (9*{cin}, Cout)")
    if not common.use_kernel(x):
        return conv3x3_fwd_plain(x, w2d)
    common.check_inputs("conv3x3_fwd", {"x": x, "w": w2d}, x.dtype)
    cout = w2d.shape[1]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    common.launch("conv3x3_fwd", library().odek_conv3x3_fwd,
                  x.data_ptr(), w2d.data_ptr(), out.data_ptr(), b, h, w, cin,
                  cout, common.DTYPE_CODES[x.dtype], common.stream_handle(x))
    return out


def conv3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    b, h, w, cin = x.shape
    cout = g.shape[3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    g2 = g.reshape(b * h * w, cout).float()
    cols = [xp[:, dy:dy + h, dx:dx + w, :].reshape(b * h * w, cin).float()
            for dy in range(3) for dx in range(3)]
    return torch.cat([c.T @ g2 for c in cols], dim=0)


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K2: input (B, H, W, Cin), cotangent (B, H, W, Cout) -> dW
    (9*Cin, Cout) in fp32."""
    b, h, w, cin = _shape_nhwc("conv3x3_wgrad", x)
    gb, gh, gw, cout = _shape_nhwc("conv3x3_wgrad", g)
    if (gb, gh, gw) != (b, h, w):
        raise ValueError(f"conv3x3_wgrad: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} differ in (B, H, W)")
    if not common.use_kernel(x):
        return conv3x3_wgrad_plain(x, g)
    common.check_inputs("conv3x3_wgrad", {"x": x, "g": g}, x.dtype)
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
