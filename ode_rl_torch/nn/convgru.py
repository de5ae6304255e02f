"""Convolutional GRU cell.

Counterpart of ``ode_rl_tpu/nn/convgru.py`` (``ConvGRUCell.__call__`` and
``_apply_mask``): a 5x5 gate convolution over concat([x, h]) producing
2*hidden channels, GroupNorm (hidden/32 groups) and sigmoid; a 5x5
candidate convolution over concat([x, r*h]), GroupNorm and tanh; then the
convex blend. The convolutions are ``F.conv2d``; the GroupNorm tails are
kernels K3/K4 (ops/gru_gates.py).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ode_rl_torch.nn.conv_stacks import Conv
from ode_rl_torch.ops.gru_gates import fused_gru_blend, fused_gru_gates

_KERNEL_SIZE = 5
_GROUPS_DIV = 32   # channels per GroupNorm group


class ConvGRUCell(nn.Module):
    """One ConvGRU step. State and input are NHWC."""

    def __init__(self, x_ch: int, hidden_dim: int, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        c = hidden_dim
        cin = x_ch + c
        self.groups_g = max(2 * c // _GROUPS_DIV, 1)
        self.groups_c = max(c // _GROUPS_DIV, 1)
        conv = lambda cout: Conv(cin, cout, _KERNEL_SIZE,
                                 padding=_KERNEL_SIZE // 2, dtype=dtype,
                                 generator=generator)
        self.conv_gates = conv(2 * c)
        self.conv_cand = conv(c)
        self.gates_scale = nn.Parameter(torch.ones(2 * c))
        self.gates_bias = nn.Parameter(torch.zeros(2 * c))
        self.cand_scale = nn.Parameter(torch.ones(c))
        self.cand_bias = nn.Parameter(torch.zeros(c))

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """h: (B, H, W, hidden); x: (B, H, W, x_ch); mask: (B,) or None."""
        gates_raw = self.conv_gates(torch.cat([x, h], dim=-1))
        z, rh = fused_gru_gates(gates_raw, h, self.gates_scale,
                                self.gates_bias, self.groups_g)
        cand_raw = self.conv_cand(torch.cat([x, rh], dim=-1))
        h_next = fused_gru_blend(cand_raw, z, h, self.cand_scale,
                                 self.cand_bias, self.groups_c)
        return self._apply_mask(h_next, h, mask)

    @staticmethod
    def _apply_mask(h_next: torch.Tensor, h: torch.Tensor,
                    mask: Optional[torch.Tensor]) -> torch.Tensor:
        if mask is not None:
            # Masked-out steps keep the old state.
            m = mask.reshape(mask.shape[0], 1, 1, 1).to(h.dtype)
            h_next = m * h_next + (1.0 - m) * h
        return h_next
