"""ConvGRU encoder-decoder video predictor, and its cgrudecODE variant.

Counterpart of ``ode_rl_tpu/models/convgru.py``: two stride-2 3x3 convs
(``enc_0``, ``enc_1``, leaky_relu 0.2; 64 -> 16 pixels), a ConvGRU
(``enc_gru``) over the observed frames, then a decoder: a second ConvGRU
(``dec_gru``) free-running one step for each output frame from the
encoder's last state, or, with ``decODE`` (cgrudecODE), a 1x1 projection
(``to_z0``) of that state integrated by a Neural-ODE field
(``dec_ode_func``, relu, no final tanh) over ``tp_to_predict``. Then two
4x4 stride-2 transposed convs (``dec_0`` with leaky_relu, ``dec_1``), a
sigmoid and MSE. Both recurrences take the fused scan functions
(nn/convgru.py), as JAX's do.

The aux output is the solver's ``nfe`` and ``ode_converged`` with
``decODE``, and empty otherwise. Inside a mesh (parallel/) the MSE is
this rank's share, over its rows of the batch and, under ``'space'``, of
the frame height; every layer knows the cut (``supports_space``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ode_rl_torch.nn.conv_stacks import (Conv, ConvNet, ConvTranspose,
                                         leaky_relu)
from ode_rl_torch.nn.convgru import (ConvGRUCell, convgru_freerun,
                                     convgru_scan)
from ode_rl_torch.ode.solvers import odeint_aux


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return leaky_relu(x, 0.2)


class ConvGRUModel(nn.Module):
    supports_space = True

    def __init__(self, in_channels: int = 1, conv_encoder_out_ch: int = 64,
                 convgru_out_ch: int = 64, kernel_size: int = 5, *,
                 decODE: bool = False, latent_dim: int = 64,
                 n_ode_layers: int = 2, neural_ode_n_units: int = 64,
                 method: str = "dopri5", rtol: float = 1e-4,
                 atol: float = 1e-5, ode_max_steps: int = 128,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.in_channels, self.hidden = in_channels, convgru_out_ch
        self.decODE = decODE
        self.method, self.rtol, self.atol = method, rtol, atol
        self.ode_max_steps = ode_max_steps
        self.dtype = dtype
        kw = dict(dtype=dtype, generator=generator)
        self.enc_0 = Conv(in_channels, 16, 3, stride=2, padding=1, **kw)
        self.enc_1 = Conv(16, conv_encoder_out_ch, 3, stride=2, padding=1,
                          **kw)
        self.enc_gru = ConvGRUCell(conv_encoder_out_ch, convgru_out_ch,
                                   kernel_size=kernel_size, **kw)
        if decODE:
            self.to_z0 = Conv(convgru_out_ch, latent_dim, 1, **kw)
            self.dec_ode_func = ConvNet(latent_dim, latent_dim,
                                        n_layers=n_ode_layers,
                                        n_units=neural_ode_n_units, **kw)
            dec_in = latent_dim
        else:
            self.dec_gru = ConvGRUCell(convgru_out_ch, convgru_out_ch,
                                       kernel_size=kernel_size, **kw)
            dec_in = convgru_out_ch
        self.dec_0 = ConvTranspose(dec_in, 32, **kw)
        self.dec_1 = ConvTranspose(32, in_channels, **kw)

    def predict(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """``generator`` is unused: the model draws no noise."""
        inputs = batch["observed_data"].to(self.dtype) + 0.5   # -> [0, 1]
        b, t_in, h, w, c = inputs.shape
        tp = batch["tp_to_predict"]
        n_out = tp.shape[0]

        x = _leaky(self.enc_0(inputs.reshape(b * t_in, h, w, c)))
        x = _leaky(self.enc_1(x))
        eh, ew = x.shape[1], x.shape[2]
        x = x.reshape(b, t_in, eh, ew, -1)
        h0 = torch.zeros((b, eh, ew, self.hidden), dtype=self.dtype,
                         device=x.device)
        _, h_last = convgru_scan(self.enc_gru, h0, x)

        aux = {}
        if self.decODE:
            z0 = self.to_z0(h_last)
            ys, stats = odeint_aux(
                lambda t, y: self.dec_ode_func(y), z0, tp,
                method=self.method, rtol=self.rtol, atol=self.atol,
                max_steps=self.ode_max_steps)
            hiddens = ys.movedim(0, 1)       # (B, T, eh, ew, latent)
            aux = {"nfe": stats.nfe, "ode_converged": int(stats.converged)}
        else:
            hiddens, _ = convgru_freerun(self.dec_gru, h_last, n_out)

        y = hiddens.reshape(b * n_out, eh, ew, -1)
        y = self.dec_1(_leaky(self.dec_0(y)))
        pred = torch.sigmoid(y).reshape(b, n_out, h, w, self.in_channels)
        return pred.float(), aux

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None):
        pred, aux = self.predict(batch, generator)
        target = batch["data_to_predict"].float() + 0.5
        mse = torch.mean(torch.square(pred - target))
        metrics = {"loss": mse, "mse": mse, **aux}
        return mse, (metrics, pred)
