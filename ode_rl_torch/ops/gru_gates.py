"""GroupNorm tails of the ConvGRU step: kernels K3 and K4.

Counterpart of ``ode_rl_tpu/ops/gru_gates.py``. The step is

    gates = GroupNorm(conv_g([x, h]));  z, r = sigmoid(split(gates))
    cand  = tanh(GroupNorm(conv_c([x, r*h])))
    h'    = (1 - z)*h + z*cand

* K3 ``fused_gru_gates`` (``csrc/gru_gates.cu``): (B,H,W,2C) raw gate conv
  output -> (z, r*h).
* K4 ``fused_gru_blend``: raw candidate conv output, z, h -> h'.

The plain versions ``_gates_plain``/``_blend_plain`` are written out as
``_gates_xla``/``_blend_xla``. The kernels form r*h and the blend in fp32
and round once, where the plain formula rounds r, z and cand to h's dtype
first. The backward of both Functions is autograd of the plain formula,
recomputed from the saved inputs, as in the JAX package.
"""

from __future__ import annotations

import torch

from ode_rl_torch.ops import common
from ode_rl_torch.ops._build import library

_EPS = 1e-5


def _groupnorm_reshape_f32(x, scale, bias, groups, eps=_EPS):
    """(B,H,W,C) GroupNorm in fp32, channels grouped contiguously on the
    last axis, one-pass moments E[x^2] - E[x]^2 clamped at 0."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h, w, groups, c // groups)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    mean2 = (xf * xf).mean(dim=(1, 2, 4), keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    norm = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return norm * scale.float() + bias.float()


def _gates_plain(gates_raw, h, scale, bias, groups):
    gn = _groupnorm_reshape_f32(gates_raw, scale, bias, groups)
    z, r = torch.sigmoid(gn).chunk(2, dim=-1)
    z = z.to(h.dtype)
    r = r.to(h.dtype)
    return z, r * h


def _blend_plain(cand_raw, z, h, scale, bias, groups):
    gn = _groupnorm_reshape_f32(cand_raw, scale, bias, groups)
    cand = torch.tanh(gn).to(h.dtype)
    zc = z.to(h.dtype)
    return (1.0 - zc) * h + zc * cand


def _check_groups(name: str, channels: int, groups: int) -> None:
    if groups < 1 or channels % groups:
        raise ValueError(f"{name}: {channels} channels do not split into "
                         f"{groups} groups")


def _gates_kernel(gates_raw, h, scale, bias, groups):
    b, hh, ww, c = h.shape
    common.check_inputs("gru_gates", {"gates_raw": gates_raw, "h": h},
                        h.dtype)
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    common.check_inputs("gru_gates", {"scale": scale, "bias": bias},
                        torch.float32)
    z = torch.empty_like(h)
    rh = torch.empty_like(h)
    common.launch("gru_gates", library().odek_gru_gates,
                  gates_raw.data_ptr(), h.data_ptr(), scale.data_ptr(),
                  bias.data_ptr(), z.data_ptr(), rh.data_ptr(), b, hh * ww, c,
                  groups, _EPS, common.DTYPE_CODES[h.dtype],
                  common.stream_handle(h))
    return z, rh


def _blend_kernel(cand_raw, z, h, scale, bias, groups):
    b, hh, ww, c = h.shape
    common.check_inputs("gru_blend", {"cand_raw": cand_raw, "z": z, "h": h},
                        h.dtype)
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    common.check_inputs("gru_blend", {"scale": scale, "bias": bias},
                        torch.float32)
    out = torch.empty_like(h)
    common.launch("gru_blend", library().odek_gru_blend,
                  cand_raw.data_ptr(), z.data_ptr(), h.data_ptr(),
                  scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
                  hh * ww, c, groups, _EPS, common.DTYPE_CODES[h.dtype],
                  common.stream_handle(h))
    return out


def _vjp_of_plain(plain, inputs, cotangents, groups):
    """Gradients of ``plain(*inputs, groups)`` for ``cotangents``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        outs = plain(*leaves, groups)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, c) for o, c in zip(outs, cotangents) if c is not None]
        return torch.autograd.grad([o for o, _ in pairs],
                                   leaves, [c for _, c in pairs],
                                   allow_unused=True)


class FusedGRUGatesFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gates_raw, h, scale, bias, groups: int):
        ctx.groups = groups
        ctx.save_for_backward(gates_raw, h, scale, bias)
        if common.use_kernel(gates_raw):
            return _gates_kernel(gates_raw, h, scale, bias, groups)
        z, rh = _gates_plain(gates_raw, h, scale, bias, groups)
        return z.contiguous(), rh

    @staticmethod
    def backward(ctx, g_z, g_rh):
        grads = _vjp_of_plain(_gates_plain, ctx.saved_tensors, (g_z, g_rh),
                              ctx.groups)
        return (*grads, None)


class FusedGRUBlendFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cand_raw, z, h, scale, bias, groups: int):
        ctx.groups = groups
        ctx.save_for_backward(cand_raw, z, h, scale, bias)
        if common.use_kernel(cand_raw):
            return _blend_kernel(cand_raw, z, h, scale, bias, groups)
        return _blend_plain(cand_raw, z, h, scale, bias, groups)

    @staticmethod
    def backward(ctx, g_out):
        grads = _vjp_of_plain(_blend_plain, ctx.saved_tensors, (g_out,),
                              ctx.groups)
        return (*grads, None)


def fused_gru_gates(gates_raw: torch.Tensor, h: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor,
                    groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B,H,W,2C) raw gate conv output -> (z, r*h), each (B,H,W,C)."""
    if gates_raw.ndim != 4 or h.ndim != 4 or (
            gates_raw.shape[:3] != h.shape[:3]
            or gates_raw.shape[3] != 2 * h.shape[3]):
        raise ValueError(f"fused_gru_gates: gates {tuple(gates_raw.shape)} "
                         f"and h {tuple(h.shape)} do not match")
    _check_groups("fused_gru_gates", gates_raw.shape[3], groups)
    return FusedGRUGatesFn.apply(gates_raw, h, scale, bias, groups)


def fused_gru_blend(cand_raw: torch.Tensor, z: torch.Tensor, h: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor,
                    groups: int) -> torch.Tensor:
    """(B,H,W,C) raw candidate conv output + gate z + state h -> h_next."""
    if h.ndim != 4 or cand_raw.shape != h.shape or z.shape != h.shape:
        raise ValueError(f"fused_gru_blend: cand {tuple(cand_raw.shape)}, "
                         f"z {tuple(z.shape)} and h {tuple(h.shape)} differ")
    _check_groups("fused_gru_blend", h.shape[3], groups)
    return FusedGRUBlendFn.apply(cand_raw, z, h, scale, bias, groups)
