"""FlowNetC's local cost volume: kernels K5, K6 and K7.

Counterpart of ``ode_rl_tpu/ops/correlation.py``. For each pixel and each
displacement (oy, ox) = (iy*stride - d, ix*stride - d), iy, ix < n with
n = 2d/stride + 1, the channel mean of f1 times the shifted f2, zero where
the window leaves the image. Output (B, H, W, n*n), displacement-major
(441 channels for FlowNetC's d = 20, stride 2).

* K5 ``correlation_fwd`` (``csrc/correlation.cu``): the forward. Its plain
  version is ``_correlation_xla`` written out over the displacements.
* K6 ``correlation_bwd_f1``: grad f1 = sum_i g_i * window_i(f2) / C.
* K7 ``correlation_bwd_f2``: grad f2 as a gather, sum over the output
  pixels whose windows cover it of g_i * f1 / C. Its plain version is that
  gather formula, not autograd of the forward, so the plain backward the
  kernels are held to is tested on its own.

``CorrelationFn`` is the ``custom_vjp`` of ``_corr_with_vjp``: K5 forward,
K6 and K7 backward. The JAX package falls back to autograd of the XLA
formula where its backward kernels would overflow the TPU's VMEM; a GPU
gather has no such limit, so the port runs K6 and K7 at every shape.

The plain versions compute in fp32 (fp64 for fp64 inputs, as references)
and round once to the input dtype, as the kernels do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ode_rl_torch.ops import common
from ode_rl_torch.ops._build import library

# K5 stages one f1 pixel's channels and its n*n outputs in fp32 shared
# memory: 48 KB without opting in to more.
_MAX_SHARED_FLOATS = 12288


def n_displacements(max_displacement: int, stride: int) -> int:
    """n per axis; the cost volume has n*n channels."""
    if max_displacement < 0 or stride < 1:
        raise ValueError(f"correlation: max_displacement {max_displacement} "
                         f"and stride {stride} must be >= 0 and >= 1")
    return 2 * max_displacement // stride + 1


def _padded_offsets(max_displacement: int, stride: int):
    """(dy, dx) of each displacement into f2 padded by d on each side."""
    n = n_displacements(max_displacement, stride)
    return [(iy * stride, ix * stride) for iy in range(n) for ix in range(n)]


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in its accumulation dtype: fp32, or fp64 for fp64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _pad_hw(x: torch.Tensor, d: int) -> torch.Tensor:
    return F.pad(_acc(x), (0, 0, d, d, d, d))


def correlation_fwd_plain(f1, f2, max_displacement, stride):
    b, h, w, c = f1.shape
    f1f = _acc(f1)
    f2p = _pad_hw(f2, max_displacement)
    out = torch.stack([(f1f * f2p[:, dy:dy + h, dx:dx + w]).mean(-1)
                       for dy, dx in _padded_offsets(max_displacement,
                                                     stride)], dim=-1)
    return out.to(f1.dtype)


def correlation_bwd_f1_plain(g, f2, max_displacement, stride):
    b, h, w, c = f2.shape
    gf = _acc(g)
    f2p = _pad_hw(f2, max_displacement)
    acc = torch.zeros_like(f2p[:, :h, :w])
    for i, (dy, dx) in enumerate(_padded_offsets(max_displacement, stride)):
        acc += gf[..., i, None] * f2p[:, dy:dy + h, dx:dx + w]
    return (acc / c).to(f2.dtype)


def correlation_bwd_f2_plain(g, f1, max_displacement, stride):
    """grad f2[q] = sum_i g_i[q - o_i] * f1[q - o_i] / C over sources in
    bounds: g and f1 padded by d with zeros, read at q + d - o_i."""
    d = max_displacement
    b, h, w, c = f1.shape
    gp = _pad_hw(g, d)
    f1p = _pad_hw(f1, d)
    acc = torch.zeros_like(f1p[:, :h, :w])
    for i, (dy, dx) in enumerate(_padded_offsets(d, stride)):
        sy, sx = 2 * d - dy, 2 * d - dx
        acc += (gp[:, sy:sy + h, sx:sx + w, i, None]
                * f1p[:, sy:sy + h, sx:sx + w])
    return (acc / c).to(f1.dtype)


def _check_nhwc_pair(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 4 or a.shape != b.shape:
        raise ValueError(f"{name}: expected two NHWC tensors of one shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")


def _check_cotangent(name, g, f, n) -> None:
    if g.shape != (*f.shape[:3], n * n):
        raise ValueError(f"{name}: cotangent {tuple(g.shape)} does not match "
                         f"{(*f.shape[:3], n * n)}")


def _launch(name, fn, a, b, out, features, max_displacement, stride):
    """Launch with pointers (a, b, out) and the (B, H, W, C) of the
    feature maps."""
    bb, h, w, c = features.shape
    common.launch(name, fn, a.data_ptr(), b.data_ptr(), out.data_ptr(), bb, h,
                  w, c, max_displacement, stride,
                  common.DTYPE_CODES[features.dtype],
                  common.stream_handle(features))


def correlation_fwd(f1: torch.Tensor, f2: torch.Tensor,
                    max_displacement: int, stride: int) -> torch.Tensor:
    """K5: f1, f2 (B, H, W, C) -> (B, H, W, n*n), f1's dtype."""
    _check_nhwc_pair("correlation_fwd", f1, f2)
    n = n_displacements(max_displacement, stride)
    if not common.use_kernel(f1):
        return correlation_fwd_plain(f1, f2, max_displacement, stride)
    common.check_inputs("correlation_fwd", {"f1": f1, "f2": f2}, f1.dtype)
    if f1.shape[3] + n * n > _MAX_SHARED_FLOATS:
        raise ValueError(f"correlation_fwd: {f1.shape[3]} channels and "
                         f"{n * n} displacements exceed {_MAX_SHARED_FLOATS} "
                         f"floats of shared memory")
    out = torch.empty((*f1.shape[:3], n * n), dtype=f1.dtype,
                      device=f1.device)
    _launch("correlation_fwd", library().odek_correlation_fwd, f1, f2, out,
            f1, max_displacement, stride)
    return out


def correlation_bwd_f1(g: torch.Tensor, f2: torch.Tensor,
                       max_displacement: int, stride: int) -> torch.Tensor:
    """K6: cotangent (B, H, W, n*n) and f2 (B, H, W, C) -> grad f1."""
    n = n_displacements(max_displacement, stride)
    _check_cotangent("correlation_bwd_f1", g, f2, n)
    if not common.use_kernel(g):
        return correlation_bwd_f1_plain(g, f2, max_displacement, stride)
    common.check_inputs("correlation_bwd_f1", {"g": g, "f2": f2}, f2.dtype)
    gf1 = torch.empty_like(f2)
    _launch("correlation_bwd_f1", library().odek_correlation_bwd_f1, g, f2,
            gf1, f2, max_displacement, stride)
    return gf1


def correlation_bwd_f2(g: torch.Tensor, f1: torch.Tensor,
                       max_displacement: int, stride: int) -> torch.Tensor:
    """K7: cotangent (B, H, W, n*n) and f1 (B, H, W, C) -> grad f2."""
    n = n_displacements(max_displacement, stride)
    _check_cotangent("correlation_bwd_f2", g, f1, n)
    if not common.use_kernel(g):
        return correlation_bwd_f2_plain(g, f1, max_displacement, stride)
    common.check_inputs("correlation_bwd_f2", {"g": g, "f1": f1}, f1.dtype)
    gf2 = torch.empty_like(f1)
    _launch("correlation_bwd_f2", library().odek_correlation_bwd_f2, g, f1,
            gf2, f1, max_displacement, stride)
    return gf2


class CorrelationFn(torch.autograd.Function):
    """K5 forward; backward grad f1 = K6, grad f2 = K7."""

    @staticmethod
    def forward(ctx, f1, f2, max_displacement: int, stride: int):
        ctx.save_for_backward(f1, f2)
        ctx.geometry = (max_displacement, stride)
        return correlation_fwd(f1, f2, max_displacement, stride)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        g = g.contiguous()
        gf1 = gf2 = None
        if ctx.needs_input_grad[0]:
            gf1 = correlation_bwd_f1(g, f2, *ctx.geometry)
        if ctx.needs_input_grad[1]:
            gf2 = correlation_bwd_f2(g, f1, *ctx.geometry)
        return gf1, gf2, None, None


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                max_displacement: int = 20, stride: int = 2) -> torch.Tensor:
    """(B,H,W,C) x (B,H,W,C) -> (B,H,W,n*n) channel-mean cost volume."""
    _check_nhwc_pair("correlation", f1, f2)
    return CorrelationFn.apply(f1.contiguous(), f2.contiguous(),
                               max_displacement, stride)
