"""ODE-ConvGRU, the flagship continuous-time video predictor.

Counterpart of ``ode_rl_tpu/models/odeconvgru.py``: conv encoder ->
backward ODE-ConvGRU z0 inference -> Neural-ODE decode of the latent
trajectory over ``tp_to_predict`` -> conv decoder and sigmoid; MSE. The
decode runs the O(NFE) dopri5 (ode/fast.py) where ``ode_solver='fast'``
and ``method`` is dopri5, and ``odeint_aux`` (ode/solvers.py: backprop
through the solver's steps, ``ode_remat`` checkpointing each dopri5
attempt) otherwise; with ``mem`` it runs ``odeint_memory``
(ode/memory.py, ``mem_mode`` 'nru' or 'nru2') from the last observed
time instead.

z0 is mu, or with ``z_sample`` mu + std * eps, eps a standard normal
drawn from the ``torch.Generator`` the caller passes (JAX draws it from
its 'sample' rng, so the two streams differ). ``z_kl_weight`` > 0 adds
the KL of N(mu, std^2) from N(0, 1), taken in fp32, as the ``z0_kl``
metric and a loss term: loss = mse + z_kl_weight * z0_kl.

The solver state and its RK arithmetic run in fp32 under bf16 compute;
the convolutions inside the field still take bf16 operands. A bf16 state
puts the embedded error's noise floor above rtol 1e-4 / atol 1e-5 and pins
the solve at its step budget.

Inside a mesh (parallel/) the loss, the MSE and ``z0_kl`` are this rank's
share: means over its rows of the batch (and of the frame height under
``'space'``), whose mean over the ranks that split the activations is
the global mean (the train step averages the gradients and the
metrics). Every layer knows the cut (``supports_space``): the convs take
their halos, K3/K4 their moments over ``'space'``, the solver's error
norm sums over ``'data'`` x ``'space'``, and a sampled z0's noise is
this rank's rows and height rows of the global draw.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ode_rl_torch.core.noise import as_noise
from ode_rl_torch.nn.conv_stacks import ConvDecoder, ConvEncoder, ConvNet
from ode_rl_torch.nn.odeconvgru import ODEConvGRUEncoder
from ode_rl_torch.ode.fast import odeint_fast
from ode_rl_torch.ode.memory import odeint_memory
from ode_rl_torch.ode.solvers import odeint_aux
from ode_rl_torch.parallel.mesh import SPACE_AXIS
from ode_rl_torch.parallel.sp import space_mesh


class ODEConvGRUModel(nn.Module):
    supports_space = True

    def __init__(self, in_channels: int = 1, n_downs: int = 2,
                 conv_encoder_out_ch: int = 64,
                 neural_ode_decoder_out_ch: int = 64,
                 neural_ode_n_units: int = 64, n_ode_layers: int = 3,
                 rtol: float = 1e-4, atol: float = 1e-5,
                 ode_max_steps: int = 128, *, method: str = "dopri5",
                 ode_solver: str = "scan", ode_remat: bool = True,
                 mem: bool = False, mem_mode: str = "nru",
                 z_sample: bool = False, z_kl_weight: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        if ode_solver not in ("scan", "fast"):
            raise ValueError(f"ode_solver {ode_solver!r}: 'scan' or 'fast'")
        if mem and mem_mode not in ("nru", "nru2"):
            raise NotImplementedError(f"memory mode {mem_mode!r} (nru|nru2)")
        self.method, self.ode_solver = method, ode_solver
        self.ode_remat = ode_remat
        self.mem, self.mem_mode = mem, mem_mode
        self.z_sample, self.z_kl_weight = z_sample, z_kl_weight
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

    def _decode(self, z0: torch.Tensor, t_start, tp_to_predict):
        if self.mem:
            return odeint_memory(
                lambda t, y: self.ode_decoder_func(y).float(), z0, t_start,
                tp_to_predict, method=self.method, rtol=self.rtol,
                atol=self.atol, max_steps=self.ode_max_steps,
                mode=self.mem_mode)
        if self.ode_solver == "fast" and self.method == "dopri5":
            ys, stats = odeint_fast(
                self._field, z0, tp_to_predict,
                dict(self.ode_decoder_func.named_parameters()),
                rtol=self.rtol, atol=self.atol, max_steps=self.ode_max_steps)
        else:
            ys, stats = odeint_aux(
                lambda t, y: self.ode_decoder_func(y).float(), z0,
                tp_to_predict, method=self.method, rtol=self.rtol,
                atol=self.atol, max_steps=self.ode_max_steps,
                remat=self.ode_remat)
        return ys, {"nfe": stats.nfe, "ode_accepted": stats.naccept,
                    "ode_rejected": stats.nreject,
                    "ode_converged": int(stats.converged)}

    def _z0(self, mu: torch.Tensor, std: torch.Tensor,
            generator: Optional[torch.Generator]):
        """(z0, z0_kl or None)."""
        if not self.z_sample:
            return mu, None
        noise = as_noise(generator, "z_sample")
        mesh = space_mesh()
        if mesh is None:
            eps = noise.normal(mu.shape, mu)
        else:
            b, h, w, c = mu.shape
            s = mesh.index(SPACE_AXIS)
            eps = noise.normal((b, h * mesh.size(SPACE_AXIS), w, c),
                               mu)[:, s * h:(s + 1) * h]
        z0_kl = None
        if self.z_kl_weight > 0.0:
            mu32, std32 = mu.float(), std.float()
            z0_kl = torch.mean(0.5 * (mu32.square() + std32.square())
                               - torch.log(std32 + 1e-6) - 0.5)
        return mu + std * eps, z0_kl

    def predict(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict]:
        inputs = batch["observed_data"].to(self.dtype) + 0.5   # -> [0, 1]
        b, t_in, h, w, c = inputs.shape

        # 1. Conv-encode the observed frames.
        enc = self.conv_encoder(inputs.reshape(b * t_in, h, w, c))
        eh, ew = enc.shape[1], enc.shape[2]
        enc = enc.reshape(b, t_in, eh, ew, -1)

        # 2. Backward ODE-ConvGRU -> (mu, std); z0 = mu, or sampled.
        mu, std = self.z0_encoder(enc, batch["observed_tp"])
        z0, z0_kl = self._z0(mu, std, generator)
        z0 = z0.float().contiguous()

        # 3. Neural-ODE decode of the latent trajectory, fp32 state.
        ys, metrics = self._decode(z0, batch["observed_tp"][-1],
                                   batch["tp_to_predict"])
        sol_y = ys.movedim(0, 1)                 # time-first -> batch-first
        if z0_kl is not None:
            metrics["z0_kl"] = z0_kl

        # 4. Conv-decode each latent frame; sigmoid to [0, 1].
        t_out = sol_y.shape[1]
        y = sol_y.reshape(b * t_out, eh, ew, -1)
        pred = torch.sigmoid(self.conv_decoder(y)).reshape(
            b, t_out, h, w, self.in_channels)
        return pred.float(), metrics

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None):
        pred, aux = self.predict(batch, generator)
        target = batch["data_to_predict"].float() + 0.5
        mse = torch.mean(torch.square(pred - target))
        loss = mse
        if "z0_kl" in aux:
            loss = loss + self.z_kl_weight * aux["z0_kl"]
        metrics = {"loss": loss, "mse": mse, **aux}
        return loss, (metrics, pred)
