"""ODE-ConvGRU, the flagship continuous-time video predictor.

Counterpart of ``ode_rl_tpu/models/odeconvgru.py`` with ``mem=False``
and ``z_sample=False``: conv encoder -> backward ODE-ConvGRU z0 inference
(z0 = mu) -> Neural-ODE decode of the latent trajectory over
``tp_to_predict`` -> conv decoder and sigmoid; MSE. The decode runs the
O(NFE) dopri5 (ode/fast.py) where ``ode_solver='fast'`` and ``method`` is
dopri5, and ``odeint_aux`` (ode/solvers.py: backprop through the solver's
steps, ``ode_remat`` checkpointing each dopri5 attempt) otherwise.

The solver state and its RK arithmetic run in fp32 under bf16 compute;
the convolutions inside the field still take bf16 operands. A bf16 state
puts the embedded error's noise floor above rtol 1e-4 / atol 1e-5 and pins
the solve at its step budget.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ode_rl_torch.nn.conv_stacks import ConvDecoder, ConvEncoder, ConvNet
from ode_rl_torch.nn.odeconvgru import ODEConvGRUEncoder
from ode_rl_torch.ode.fast import odeint_fast
from ode_rl_torch.ode.solvers import odeint_aux


class ODEConvGRUModel(nn.Module):
    def __init__(self, in_channels: int = 1, n_downs: int = 2,
                 conv_encoder_out_ch: int = 64,
                 neural_ode_decoder_out_ch: int = 64,
                 neural_ode_n_units: int = 64, n_ode_layers: int = 3,
                 rtol: float = 1e-4, atol: float = 1e-5,
                 ode_max_steps: int = 128, *, method: str = "dopri5",
                 ode_solver: str = "scan", ode_remat: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        if ode_solver not in ("scan", "fast"):
            raise ValueError(f"ode_solver {ode_solver!r}: 'scan' or 'fast'")
        self.method, self.ode_solver = method, ode_solver
        self.ode_remat = ode_remat
        if neural_ode_decoder_out_ch != conv_encoder_out_ch:
            raise ValueError("the decode field maps the z0 state to itself: "
                             "neural_ode_decoder_out_ch must equal "
                             "conv_encoder_out_ch")
        self.in_channels = in_channels
        self.rtol, self.atol, self.ode_max_steps = rtol, atol, ode_max_steps
        self.dtype = dtype
        ch = conv_encoder_out_ch
        self.conv_encoder = ConvEncoder(in_channels, ch, n_downs=n_downs,
                                        dtype=dtype, generator=generator)
        self.z0_encoder = ODEConvGRUEncoder(
            ch, ode_n_layers=n_ode_layers, ode_n_units=neural_ode_n_units,
            dtype=dtype, generator=generator)
        self.ode_decoder_func = ConvNet(
            ch, neural_ode_decoder_out_ch, n_layers=n_ode_layers,
            n_units=neural_ode_n_units, dtype=dtype, generator=generator)
        self.conv_decoder = ConvDecoder(
            neural_ode_decoder_out_ch, in_channels, n_ups=n_downs,
            dtype=dtype, generator=generator)

    def _field(self, t, y: torch.Tensor, params) -> torch.Tensor:
        # Autonomous: t is ignored. The state stays fp32.
        return functional_call(self.ode_decoder_func, params, (y,)).float()

    def _decode(self, z0: torch.Tensor, tp_to_predict):
        if self.ode_solver == "fast" and self.method == "dopri5":
            return odeint_fast(
                self._field, z0, tp_to_predict,
                dict(self.ode_decoder_func.named_parameters()),
                rtol=self.rtol, atol=self.atol, max_steps=self.ode_max_steps)
        return odeint_aux(
            lambda t, y: self.ode_decoder_func(y).float(), z0, tp_to_predict,
            method=self.method, rtol=self.rtol, atol=self.atol,
            max_steps=self.ode_max_steps, remat=self.ode_remat)

    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict]:
        inputs = batch["observed_data"].to(self.dtype) + 0.5   # -> [0, 1]
        b, t_in, h, w, c = inputs.shape

        # 1. Conv-encode the observed frames.
        enc = self.conv_encoder(inputs.reshape(b * t_in, h, w, c))
        eh, ew = enc.shape[1], enc.shape[2]
        enc = enc.reshape(b, t_in, eh, ew, -1)

        # 2. Backward ODE-ConvGRU -> (mu, std); z0 = mu.
        mu, _std = self.z0_encoder(enc, batch["observed_tp"])
        z0 = mu.float().contiguous()

        # 3. Neural-ODE decode of the latent trajectory, fp32 state.
        ys, stats = self._decode(z0, batch["tp_to_predict"])
        sol_y = ys.movedim(0, 1)                 # time-first -> batch-first
        metrics = {"nfe": stats.nfe, "ode_accepted": stats.naccept,
                   "ode_rejected": stats.nreject,
                   "ode_converged": int(stats.converged)}

        # 4. Conv-decode each latent frame; sigmoid to [0, 1].
        t_out = sol_y.shape[1]
        y = sol_y.reshape(b * t_out, eh, ew, -1)
        pred = torch.sigmoid(self.conv_decoder(y)).reshape(
            b, t_out, h, w, self.in_channels)
        return pred.float(), metrics

    def loss(self, batch: Dict[str, torch.Tensor]):
        pred, aux = self.predict(batch)
        target = batch["data_to_predict"].float() + 0.5
        mse = torch.mean(torch.square(pred - target))
        metrics = {"loss": mse, "mse": mse, **aux}
        return mse, (metrics, pred)
