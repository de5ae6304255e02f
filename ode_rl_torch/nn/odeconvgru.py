"""ODE-ConvGRU z0-inference encoder.

Counterpart of ``ode_rl_tpu/nn/odeconvgru.py``: iterate the encoded
frames backwards in time; at each step advance the running latent by one
explicit Euler step of the dynamics field, then fuse the observation
through a ConvGRU update. A (B, T) ``mask`` (Vid-ODE's irregular
observations) is reversed with the frames and gates each step's ConvGRU
update: where it is 0 the state keeps its Euler step's value, the
update discarded. Without one, no gating runs. A 1x1-conv head maps the final
latent to (mu, |std|), each of ``out_ch`` channels (``ch`` unless given:
S3VAE's ``odecgru`` dynamic head gives fewer).

``hoist_projections`` (off by default, as in JAX) computes the
observation-side halves of the ConvGRU's gate convolutions for every
frame as one batched convolution before the loop (``project_x``), and
each step then runs the cell's ``step_fused``.

The first (latest-frame) Euler step uses dt = -0.01 whatever the time
grid; later steps use the reversed grid spacing ts[i] - ts[i+1].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.nn.conv_stacks import Conv, ConvNet
from ode_rl_torch.nn.convgru import ConvGRUCell

_FIRST_DT = -0.01   # the reference's ts[-1] + 0.01 bootstrap


class _EulerGRUStep(nn.Module):
    """One backward step: explicit Euler on the field, then a ConvGRU
    fuse with the encoded observation."""

    def __init__(self, ch: int, ode_n_layers: int, ode_n_units: int, *,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.ode_func = ConvNet(ch, ch, n_layers=ode_n_layers,
                                n_units=ode_n_units, dtype=dtype,
                                generator=generator)
        self.cgru_cell = ConvGRUCell(ch, ch, dtype=dtype, generator=generator)

    def forward(self, prev: torch.Tensor, x_i: torch.Tensor,
                dt_i: torch.Tensor,
                m_i: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_i = x_i.to(prev.dtype)
        dt_i = dt_i.to(prev.dtype)
        yi_ode = prev + self.ode_func(prev) * dt_i
        return self.cgru_cell(yi_ode, x_i, m_i)

    def fused(self, prev: torch.Tensor, gx_i: torch.Tensor,
              cx_i: torch.Tensor, dt_i: torch.Tensor,
              m_i: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The same step on the observation's hoisted projections."""
        yi_ode = prev + self.ode_func(prev) * dt_i.to(prev.dtype)
        return self.cgru_cell.step_fused(yi_ode, gx_i.to(prev.dtype),
                                         cx_i.to(prev.dtype), m_i)


class ODEConvGRUEncoder(nn.Module):
    """Backward ODE-ConvGRU pass producing (mu_z0, std_z0)."""

    def __init__(self, ch: int, ode_n_layers: int = 2, ode_n_units: int = 64,
                 *, out_ch: Optional[int] = None,
                 hoist_projections: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.ch = ch
        self.hoist_projections = hoist_projections
        self.dtype = dtype
        self.step = _EulerGRUStep(ch, ode_n_layers, ode_n_units, dtype=dtype,
                                  generator=generator)
        self.head_0 = Conv(ch, ch, 1, dtype=dtype, generator=generator)
        self.head_1 = Conv(ch, 2 * (out_ch or ch), 1, dtype=dtype,
                           generator=generator)

    def forward(self, xs: torch.Tensor, timesteps: torch.Tensor,
                mask: Optional[torch.Tensor] = None):
        """xs: (B, T, H, W, ch) encoded observations; timesteps: (T,);
        mask: (B, T) or None."""
        b, t, h, w, _ = xs.shape
        spacing = timesteps[:-1] - timesteps[1:]           # negative steps
        dts = torch.cat([torch.full((1,), _FIRST_DT, dtype=timesteps.dtype,
                                    device=timesteps.device),
                         spacing.flip(0)])
        prev = torch.zeros((b, h, w, self.ch), dtype=self.dtype,
                           device=xs.device)
        m = lambda i: None if mask is None else mask[:, t - 1 - i]
        if self.hoist_projections:
            gx, cx = self.step.cgru_cell.project_x(
                xs.reshape(b * t, h, w, -1))
            gx = gx.reshape(b, t, *gx.shape[1:])
            cx = cx.reshape(b, t, *cx.shape[1:])
            for i in range(t):
                prev = self.step.fused(prev, gx[:, t - 1 - i],
                                       cx[:, t - 1 - i], dts[i], m(i))
        else:
            for i in range(t):
                prev = self.step(prev, xs[:, t - 1 - i], dts[i], m(i))
        z = F.relu(self.head_0(prev))
        mu, std = self.head_1(z).chunk(2, dim=-1)
        return mu, std.abs()
