"""Per-pixel L2 norm over channels: kernel K8.

Counterpart of ``ode_rl_tpu/ops/channelnorm.py``. (B, H, W, C) ->
(B, H, W, 1), ``sqrt(sum_c x^2)`` reduced in fp32 and written in the input
dtype. FlowNet2's stacking feeds it brightness errors (C = 3) and flows
(C = 2).

* K8 ``channelnorm_fwd`` (``csrc/channelnorm.cu``), one thread a pixel.
  Its plain version is ``_channelnorm_xla`` with the channels added in
  order, as the kernel adds them (without fused multiply-adds), so the two
  agree bit for bit.

``ChannelNormFn`` has the hand-written backward of ``_cn_op``,
``x * g / max(norm, 1e-12)``, which is 0 where the norm is 0 (autograd of
the square root gives 0/0 there, and MNIST frames have exactly-zero
backgrounds). That backward is a jnp formula in JAX, so it stays a torch
expression here, on the same norm as the forward.
"""

from __future__ import annotations

import torch

from ode_rl_torch.ops import common
from ode_rl_torch.ops._build import library


def _norm(x: torch.Tensor) -> torch.Tensor:
    """The norm in fp32 (fp64 for fp64 inputs, as a reference), the squares
    added in channel order as K8 adds them. (``torch.sum`` on the card
    groups a row's terms by its address, so its fp32 result differs from
    row to row in the last bit.)"""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    sq = xf * xf
    total = sq[..., :1]
    for c in range(1, x.shape[-1]):
        total = total + sq[..., c:c + 1]
    return torch.sqrt(total)


def channelnorm_plain(x: torch.Tensor) -> torch.Tensor:
    return _norm(x).to(x.dtype)


def channelnorm_fwd(x: torch.Tensor) -> torch.Tensor:
    """K8: (B, H, W, C) -> (B, H, W, 1), x's dtype."""
    if x.ndim != 4:
        raise ValueError(f"channelnorm: expected NHWC (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    if not common.use_kernel(x):
        return channelnorm_plain(x)
    common.check_inputs("channelnorm", {"x": x}, x.dtype)
    out = torch.empty((*x.shape[:3], 1), dtype=x.dtype, device=x.device)
    common.launch("channelnorm", library().odek_channelnorm, x.data_ptr(),
                  out.data_ptr(), out.numel(), x.shape[3],
                  common.DTYPE_CODES[x.dtype], common.stream_handle(x))
    return out


class ChannelNormFn(torch.autograd.Function):
    """K8 forward; backward x * g / max(norm, 1e-12)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return channelnorm_fwd(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        gx = x.float() * (g.float() / torch.clamp_min(_norm(x), 1e-12))
        return gx.to(x.dtype)


def channelnorm(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, 1) per-pixel L2 norm over channels."""
    return ChannelNormFn.apply(x.contiguous())
