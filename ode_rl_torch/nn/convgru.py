"""Convolutional GRU cell and its scan functions.

Counterpart of ``ode_rl_tpu/nn/convgru.py``: a ``kernel_size`` gate
convolution over concat([x, h]) producing 2*hidden channels, GroupNorm
(channels/``groups_div`` groups) and sigmoid; a candidate convolution over
concat([x, r*h]), GroupNorm and tanh; then the convex blend. The
convolutions are ``F.conv2d`` (JAX computes them with
``lax.conv_general_dilated``, outside any Pallas kernel); the GroupNorm
tails are kernels K3/K4 (ops/gru_gates.py).

A convolution over concat([x, h]) is the sum of one over x with the
kernel's x-side input channels and one over h with its h-side ones. The
fused scans use that: ``project_x`` computes the x-side halves (biases
folded in) of every step as one batched convolution before the loop,
``project_zero`` gives a free-run's (a zero input leaves only the
biases), and ``step_fused`` runs only the h-side convolutions. Both
functions default to the fused path, as JAX's do; the unfused path calls the
cell on the concatenation at every step. Inside a mesh each convolution
is column-parallel where its kernel holds a ``'model'`` slice, and takes
its halo rows under ``'space'`` (nn/conv_stacks.py); K3/K4 then take
GroupNorm moments summed over ``'space'`` (ops/gru_gates.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ode_rl_torch.nn.conv_stacks import Conv, conv2d_nhwc
from ode_rl_torch.ops.gru_gates import fused_gru_blend, fused_gru_gates
from ode_rl_torch.parallel.tp import is_sharded


def _conv_same(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], dtype: torch.dtype,
               sharded: bool = False) -> torch.Tensor:
    """Stride-1 SAME conv of NHWC ``x`` with an OIHW ``weight`` (a slice
    of a cell's kernel's input channels), the bias added after the conv
    where given; column-parallel where the cell's kernel is ``sharded``
    over ``'model'``, with a halo under ``'space'`` (conv2d_nhwc)."""
    return conv2d_nhwc(x, weight, bias, 1, weight.shape[-1] // 2, dtype,
                       sharded)


class ConvGRUCell(nn.Module):
    """One ConvGRU step. State and input are NHWC.

    ``x_ch`` is the input's channels; a cell that free-runs (``x=None``,
    ``project_zero``) is fed zeros of the hidden width, so it takes
    ``x_ch == hidden_dim``, and the x-side half of its kernels never
    sees a nonzero input (JAX declares the same shapes, so checkpoints
    interchange)."""

    def __init__(self, x_ch: int, hidden_dim: int, *, kernel_size: int = 5,
                 groups_div: int = 32, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        c = hidden_dim
        cin = x_ch + c
        self.x_ch, self.hidden_dim, self.dtype = x_ch, c, dtype
        self.groups_g = max(2 * c // groups_div, 1)
        self.groups_c = max(c // groups_div, 1)
        conv = lambda cout: Conv(cin, cout, kernel_size,
                                 padding=kernel_size // 2, dtype=dtype,
                                 generator=generator)
        self.conv_gates = conv(2 * c)
        self.conv_cand = conv(c)
        self.gates_scale = nn.Parameter(torch.ones(2 * c))
        self.gates_bias = nn.Parameter(torch.zeros(2 * c))
        self.cand_scale = nn.Parameter(torch.ones(c))
        self.cand_bias = nn.Parameter(torch.zeros(c))

    def _check_free_run(self) -> None:
        if self.x_ch != self.hidden_dim:
            raise ValueError(f"a free-running cell takes zeros of the hidden "
                             f"width {self.hidden_dim}; this one was built "
                             f"for {self.x_ch} input channels")

    def forward(self, h: torch.Tensor, x: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """h: (B, H, W, hidden); x: (B, H, W, x_ch), or None for a
        free-run step (zeros of the hidden width); mask: (B,) or None."""
        if x is None:
            self._check_free_run()
            x = torch.zeros_like(h)
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

    def project_x(self, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The x-side halves of both gate convs, biases folded in. ``x``:
        (N, H, W, x_ch); callers flatten (B, T) into N."""
        cx = self.x_ch
        return (_conv_same(x, self.conv_gates.weight[:, :cx],
                           self.conv_gates.bias, self.dtype,
                           is_sharded(self.conv_gates)),
                _conv_same(x, self.conv_cand.weight[:, :cx],
                           self.conv_cand.bias, self.dtype,
                           is_sharded(self.conv_cand)))

    def project_zero(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """A free-run's input projection: the conv of zeros is the bias."""
        self._check_free_run()
        return (self.conv_gates.bias.to(self.dtype).reshape(1, 1, 1, -1),
                self.conv_cand.bias.to(self.dtype).reshape(1, 1, 1, -1))

    def step_fused(self, h: torch.Tensor, gx: torch.Tensor, cx: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step given the input projections (gx, cx) of
        ``project_x``/``project_zero``: only the h-side convs run here."""
        xc = self.x_ch
        gates_raw = gx + _conv_same(h, self.conv_gates.weight[:, xc:], None,
                                    self.dtype,
                                    is_sharded(self.conv_gates))
        z, rh = fused_gru_gates(gates_raw, h, self.gates_scale,
                                self.gates_bias, self.groups_g)
        cand_raw = cx + _conv_same(rh, self.conv_cand.weight[:, xc:], None,
                                   self.dtype,
                                   is_sharded(self.conv_cand))
        h_next = fused_gru_blend(cand_raw, z, h, self.cand_scale,
                                 self.cand_bias, self.groups_c)
        return self._apply_mask(h_next, h, mask)


def convgru_scan(cell: ConvGRUCell, h0: torch.Tensor, xs: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, reverse: bool = False,
                 fused: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``cell`` over xs (B, T, H, W, C) from h0, backwards in time
    where ``reverse``; mask (B, T) or None. Returns (hiddens (B, T, ...)
    in the inputs' time order, the last state computed)."""
    b, t = xs.shape[:2]
    if fused:
        gx, cx = cell.project_x(xs.reshape(b * t, *xs.shape[2:]))
        gx = gx.reshape(b, t, *gx.shape[1:])
        cx = cx.reshape(b, t, *cx.shape[1:])
    hs = [None] * t
    h = h0
    for i in (range(t - 1, -1, -1) if reverse else range(t)):
        m = None if mask is None else mask[:, i]
        hs[i] = h = (cell.step_fused(h, gx[:, i], cx[:, i], m) if fused
                     else cell(h, xs[:, i], m))
    return torch.stack(hs, dim=1), h


def convgru_freerun(cell: ConvGRUCell, h0: torch.Tensor, n_steps: int,
                    fused: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Free-run ``cell`` from h0 for ``n_steps`` with zero input. Returns
    (hiddens (B, n_steps, ...), the last state). Fused, each step runs
    only the h-side convs: half the conv work of the unfused step."""
    gx_cx = cell.project_zero() if fused else None
    hs = []
    h = h0
    for _ in range(n_steps):
        h = cell.step_fused(h, *gx_cx) if fused else cell(h, None)
        hs.append(h)
    return torch.stack(hs, dim=1), h
