"""ODE-ConvGRU z0-inference encoder.

Counterpart of ``ode_rl_tpu/nn/odeconvgru.py`` on its default path
(``hoist_projections=False``, no mask): iterate the encoded frames
backwards in time; at each step advance the running latent by one
explicit Euler step of the dynamics field, then fuse the observation
through a ConvGRU update. A 1x1-conv head maps the final latent to
(mu, |std|).

The first (latest-frame) Euler step uses dt = -0.01 whatever the time
grid; later steps use the reversed grid spacing ts[i] - ts[i+1].
"""

from __future__ import annotations

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
                dt_i: torch.Tensor) -> torch.Tensor:
        x_i = x_i.to(prev.dtype)
        dt_i = dt_i.to(prev.dtype)
        yi_ode = prev + self.ode_func(prev) * dt_i
        return self.cgru_cell(yi_ode, x_i)


class ODEConvGRUEncoder(nn.Module):
    """Backward ODE-ConvGRU pass producing (mu_z0, std_z0)."""

    def __init__(self, ch: int, ode_n_layers: int = 2, ode_n_units: int = 64,
                 *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.ch = ch
        self.dtype = dtype
        self.step = _EulerGRUStep(ch, ode_n_layers, ode_n_units, dtype=dtype,
                                  generator=generator)
        self.head_0 = Conv(ch, ch, 1, dtype=dtype, generator=generator)
        self.head_1 = Conv(ch, 2 * ch, 1, dtype=dtype, generator=generator)

    def forward(self, xs: torch.Tensor, timesteps: torch.Tensor):
        """xs: (B, T, H, W, ch) encoded observations; timesteps: (T,)."""
        b, t, h, w, _ = xs.shape
        spacing = timesteps[:-1] - timesteps[1:]           # negative steps
        dts = torch.cat([torch.full((1,), _FIRST_DT, dtype=timesteps.dtype,
                                    device=timesteps.device),
                         spacing.flip(0)])
        prev = torch.zeros((b, h, w, self.ch), dtype=self.dtype,
                           device=xs.device)
        for i in range(t):
            prev = self.step(prev, xs[:, t - 1 - i], dts[i])
        z = F.relu(self.head_0(prev))
        mu, std = self.head_1(z).chunk(2, dim=-1)
        return mu, std.abs()
