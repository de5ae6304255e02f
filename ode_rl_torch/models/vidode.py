"""Vid-ODE, continuous-time video prediction by flow composition.

Counterpart of ``ode_rl_tpu/models/vidode.py``: a conv encoder (a 3x3
conv, then ``n_downs`` 4x4 stride-2 convs, each with BatchNorm and relu)
-> the backward ODE-ConvGRU z0 encoder, gated by the batch's
``observed_mask`` -> the Neural-ODE decode of the latent over
``tp_to_predict`` (``odeint_aux``, or ``odeint_memory`` from the last
observed time with ``mem``) -> a decoder (bilinear x2 resize, conv,
BatchNorm, relu; then ``conv_out``) on [sol_y(t), sol_y(t - 1)], the
first ``prev`` being the last observed frame's embedding, which gives a
flow (2 channels), an intermediate frame (C) and a mask (1, sigmoid) at
full resolution. The last observed frame is warped recursively by the
flows (``grid_sample``, border padding, the flow divided by
((W - 1) / 2, (H - 1) / 2)) and composited: pred = mask * warped +
(1 - mask) * intermediate. Loss: L1 of the prediction plus L1 of the
intermediates against the frame differences of [last observed frame,
targets].

The slot variant (``slot_attention``, ``pos`` 2 only): the encoder's
features plus ``SoftPositionEmbed``, flattened, go through slot attention
(MLP width ``slot_dim``); each slot is broadcast over the latent grid and
the slots fold into the batch (B * S programs of ``slot_dim`` channels,
the mask repeated for each slot); each program decodes flow, intermediate,
mask and an alpha channel, warps the last frame with its own flows, and
the programs' predictions and intermediates blend by the softmax of alpha
over the slots. The slots' initial noise is one (B, S, slot_dim) draw a
video, shared by its frames, from the caller's generator;
``batch["slot_noise"]`` overrides it.

BatchNorm follows ``train``, which defaults to the module's mode, and
moves its running statistics (buffers) in training. The grids are
``linspace`` rounded once from fp64, within an fp32 ulp of JAX's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.core.noise import as_noise
from ode_rl_torch.nn.conv_stacks import Conv, ConvNet
from ode_rl_torch.nn.norm import BatchNorm
from ode_rl_torch.nn.odeconvgru import ODEConvGRUEncoder
from ode_rl_torch.nn.slot_attention import (SlotAttention, SoftPositionEmbed,
                                            spatial_broadcast)
from ode_rl_torch.ode.memory import odeint_memory
from ode_rl_torch.ode.solvers import odeint_aux
from ode_rl_torch.ops.resize import resize_bilinear
from ode_rl_torch.ops.warp import grid_sample, linspace


class _VidODEEncoder(nn.Module):
    def __init__(self, in_ch: int, ch: int = 32, n_downs: int = 2, *,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.n_downs = n_downs
        self.conv_in = Conv(in_ch, ch, 3, padding=1, **kw)
        self.bn_in = BatchNorm(ch)
        for i in range(n_downs):
            self.add_module(f"conv_{i}", Conv(ch, 2 * ch, 4, stride=2,
                                              padding=1, **kw))
            self.add_module(f"bn_{i}", BatchNorm(2 * ch))
            ch *= 2

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = F.relu(self.bn_in(self.conv_in(x), train))
        for i in range(self.n_downs):
            x = F.relu(getattr(self, f"bn_{i}")(
                getattr(self, f"conv_{i}")(x), train))
        return x


class _VidODEDecoder(nn.Module):
    def __init__(self, in_ch: int, out_dim: int, n_ups: int = 2, *,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.n_ups = n_ups
        ch = in_ch
        for i in range(n_ups):
            self.add_module(f"conv_{i}", Conv(ch, ch // 2, 3, padding=1,
                                              **kw))
            self.add_module(f"bn_{i}", BatchNorm(ch // 2))
            ch //= 2
        self.conv_out = Conv(ch, out_dim, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        for i in range(self.n_ups):
            _, h, w, _ = x.shape
            x = resize_bilinear(x, 2 * h, 2 * w)
            x = F.relu(getattr(self, f"bn_{i}")(
                getattr(self, f"conv_{i}")(x), train))
        return self.conv_out(x)


class VidODEModel(nn.Module):
    def __init__(self, in_channels: int = 1, n_downs: int = 2,
                 base_ch: int = 32, n_layers: int = 3,
                 method: str = "dopri5", rtol: float = 1e-3,
                 atol: float = 1e-4, ode_max_steps: int = 128,
                 slot_attention: bool = False, num_slots: int = 4,
                 slot_dim: int = 32, pos: int = 2, slot_iters: int = 3,
                 mem: bool = False, mem_mode: str = "nru", *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        if slot_attention and pos != 2:
            raise NotImplementedError(
                "pos=1 slot placement is a dead `pass` branch in the "
                "reference: only pos=2 has a design to build")
        if mem and mem_mode not in ("nru", "nru2"):
            raise NotImplementedError(f"memory mode {mem_mode!r} (nru|nru2)")
        self.method, self.rtol, self.atol = method, rtol, atol
        self.ode_max_steps = ode_max_steps
        # The flag is ``slots``: ``slot_attention`` is the submodule, as
        # flax names it.
        self.slots = slot_attention
        self.num_slots, self.slot_dim = num_slots, slot_dim
        self.mem, self.mem_mode, self.dtype = mem, mem_mode, dtype
        kw = dict(dtype=dtype, generator=generator)
        latent_ch = base_ch * 2 ** n_downs
        self.conv_encoder = _VidODEEncoder(in_channels, base_ch, n_downs,
                                           **kw)
        if slot_attention:
            self.encoder_pos = SoftPositionEmbed(latent_ch,
                                                 generator=generator)
            self.slot_attention = SlotAttention(
                latent_ch, num_slots=num_slots, num_iterations=slot_iters,
                slot_size=slot_dim, mlp_hidden=slot_dim, generator=generator)
            ch_lat, ode_units, out_extra = slot_dim, slot_dim, 2
        else:
            ch_lat, ode_units, out_extra = latent_ch, latent_ch // 2, 1
        self.encoder_z0 = ODEConvGRUEncoder(ch_lat, ode_n_layers=n_layers,
                                            ode_n_units=ode_units, **kw)
        self.ode_decoder_func = ConvNet(ch_lat, ch_lat, n_layers=n_layers,
                                        n_units=ode_units, **kw)
        self.conv_decoder = _VidODEDecoder(
            2 * ch_lat, in_channels + 2 + out_extra, n_ups=n_downs, **kw)

    def _slots(self, enc: torch.Tensor, b: int, t_in: int,
               batch: Dict, generator) -> torch.Tensor:
        """Encoder features (B * T, eh, ew, C) -> slot maps (B * S, T,
        eh, ew, slot_dim)."""
        s, d = self.num_slots, self.slot_dim
        _, eh, ew, c = enc.shape
        feats = self.encoder_pos(enc)
        flat = feats.reshape(b * t_in, eh * ew, c)
        noise = batch.get("slot_noise")
        noise = (noise.to(self.dtype) if noise is not None else
                 as_noise(generator, "VidODE's slot attention").normal(
                     (b, s, d), enc))
        noise_bt = noise[:, None].expand(b, t_in, s, d).reshape(
            b * t_in, s, d)
        slots = self.slot_attention(flat, init_noise=noise_bt)
        bcast = spatial_broadcast(slots, (eh, ew)).reshape(
            b, t_in, s, eh, ew, d)
        return bcast.movedim(2, 1).reshape(b * s, t_in, eh, ew, d)

    def _decode(self, mu: torch.Tensor, batch: Dict):
        field = lambda t, y: self.ode_decoder_func(y)
        if self.mem:
            ys, stats = odeint_memory(
                field, mu, batch["observed_tp"][-1], batch["tp_to_predict"],
                method=self.method, rtol=self.rtol, atol=self.atol,
                max_steps=self.ode_max_steps, mode=self.mem_mode)
            return ys, {"nfe": stats["nfe"], "ode_converged": 1}
        ys, stats = odeint_aux(field, mu, batch["tp_to_predict"],
                               method=self.method, rtol=self.rtol,
                               atol=self.atol, max_steps=self.ode_max_steps)
        return ys, {"nfe": stats.nfe, "ode_converged": int(stats.converged)}

    def predict(self, batch: Dict[str, torch.Tensor], generator=None,
                train: Optional[bool] = None) -> Tuple[torch.Tensor, Dict]:
        train = self.training if train is None else train
        inputs = batch["observed_data"].to(self.dtype) + 0.5   # [0, 1]
        mask = batch.get("observed_mask")
        b, t_in, h, w, c = inputs.shape

        enc = self.conv_encoder(inputs.reshape(b * t_in, h, w, c), train)
        eh, ew = enc.shape[1], enc.shape[2]
        if self.slots:
            enc_seq = self._slots(enc, b, t_in, batch, generator)
            if mask is not None:
                # Slots share their video's mask.
                mask = mask.repeat_interleave(self.num_slots, dim=0)
        else:
            enc_seq = enc.reshape(b, t_in, eh, ew, -1)
        n_prog = enc_seq.shape[0]

        mu, _ = self.encoder_z0(enc_seq, batch["observed_tp"], mask=mask)
        ys, metrics = self._decode(mu, batch)
        sol_y = ys.movedim(0, 1)                   # (N, T, eh, ew, C)
        t_out = sol_y.shape[1]

        # The decoder reads [sol_y(t), prev], prev the latent sequence
        # shifted by one and seeded by the last observed embedding.
        prev_seq = torch.cat([enc_seq[:, -1:], sol_y[:, :-1]], dim=1)
        dec_in = torch.cat([sol_y, prev_seq], dim=-1)
        maps = self.conv_decoder(dec_in.reshape(n_prog * t_out, eh, ew, -1),
                                 train).reshape(n_prog, t_out, h, w, -1)
        flows = maps[..., :2]
        inter = maps[..., 2:2 + c]
        masks = torch.sigmoid(maps[..., 2 + c:3 + c])

        # The recursive warp of the last observed frame.
        gy, gx = torch.meshgrid(linspace(-1.0, 1.0, h, maps.device),
                                linspace(-1.0, 1.0, w, maps.device),
                                indexing="ij")
        base_grid = torch.stack([gx, gy], dim=-1).to(maps.dtype)
        norm = torch.tensor([(w - 1.0) / 2.0, (h - 1.0) / 2.0],
                            dtype=maps.dtype, device=maps.device)
        frame = inputs[:, -1]
        if self.slots:
            frame = frame.repeat_interleave(self.num_slots, dim=0)
        warped = []
        for i in range(t_out):
            frame = grid_sample(frame, base_grid + flows[:, i] / norm)
            warped.append(frame)
        warped = torch.stack(warped, dim=1)

        pred = masks * warped + (1.0 - masks) * inter
        if self.slots:
            s = self.num_slots
            unfold = lambda v: v.reshape(b, s, *v.shape[1:])
            alpha = torch.softmax(unfold(maps[..., 3 + c:]), dim=1)
            pred = torch.sum(alpha * unfold(pred), dim=1)
            inter = torch.sum(alpha * unfold(inter), dim=1)
            flows, masks = unfold(flows), unfold(masks)
        metrics.update({"_intermediates": inter, "_flows": flows,
                        "_masks": masks})
        return pred.float(), metrics

    def loss(self, batch: Dict[str, torch.Tensor], generator=None,
             train: Optional[bool] = None):
        pred, aux = self.predict(batch, generator, train)
        target = batch["data_to_predict"].float() + 0.5
        inter = aux.pop("_intermediates").float()
        recon_l1 = torch.mean(torch.abs(pred - target))
        # The intermediates against the differences of [last observed
        # frame, targets].
        init = batch["observed_data"][:, -1:].float() + 0.5
        seq = torch.cat([init, target], dim=1)
        diff_l1 = torch.mean(torch.abs(inter - (seq[:, 1:] - seq[:, :-1])))
        loss = recon_l1 + diff_l1
        metrics = {"loss": loss, "recon_l1": recon_l1, "diff_l1": diff_l1,
                   **{k: v for k, v in aux.items() if not k.startswith("_")}}
        return loss, (metrics, pred)
