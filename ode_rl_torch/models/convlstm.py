"""Stacked ConvLSTM encoder-forecaster.

Counterpart of ``ode_rl_tpu/models/convlstm.py``:

* ``ConvLSTMCell``: one 5x5 gate conv over concat([x, h]) to 4F
  channels (``gates``, OIHW), GroupNorm (``norm``: 4F/32 groups of
  contiguous channels, flax's eps 1e-6, nn/norm.py), then i, f, g, o =
  sigmoid, sigmoid, tanh, sigmoid; c' = f c + i g, h' = o tanh(c'). The
  gates are plain torch: JAX computes them outside any Pallas kernel.
  As in nn/convgru.py, the conv over concat([x, h]) is split by input
  channels: ``project_x`` runs the x-side half of every step as one
  batched conv (bias folded in), ``project_zero`` is a free-run's (the
  bias alone), and ``step_fused`` runs only the h-side half;
* ``scan_cell``: the fused driver (default) and the unfused one, which
  calls the cell on the concatenation at every step;
* ``ConvLSTMED``: per encoder stage a strided 3x3 conv (leaky_relu 0.2)
  over all frames, then a ConvLSTM over time from zeros; the forecaster
  takes the stages' last states in reverse order, free-runs its first
  cell, and between cells upsamples with 4x4 stride-2 'SAME' transposed
  convs (torch's padding 1 on the flipped kernel, convert.py); the head
  is a transposed conv to 64 channels, a 3x3 conv to 16 and a 1x1 conv
  out, then the sigmoid. The loss is the MSE against
  ``data_to_predict + 0.5``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ode_rl_torch.nn.conv_stacks import Conv, ConvTranspose, leaky_relu
from ode_rl_torch.nn.convgru import _conv_same
from ode_rl_torch.nn.norm import GroupNorm

Carry = Tuple[torch.Tensor, torch.Tensor]


class ConvLSTMCell(nn.Module):
    def __init__(self, x_ch: int, num_features: int, *,
                 filter_size: int = 5, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        f = num_features
        self.x_ch, self.num_features, self.dtype = x_ch, f, dtype
        self.gates = Conv(x_ch + f, 4 * f, filter_size,
                          padding=filter_size // 2, dtype=dtype,
                          generator=generator)
        self.norm = GroupNorm(4 * f, max(4 * f // 32, 1))

    def forward(self, carry: Carry, x: Optional[torch.Tensor]
                ) -> Tuple[Carry, torch.Tensor]:
        """One unfused step; ``x`` None is a free-run step (zeros of the
        hidden width)."""
        h, c = carry
        if x is None:
            x = torch.zeros_like(h)
        return self._finish(c, self.gates(torch.cat([x, h], dim=-1)))

    def project_x(self, x: torch.Tensor) -> torch.Tensor:
        """The x-side half of the gate conv, bias folded in: (N, H, W,
        x_ch) -> (N, H, W, 4F)."""
        return _conv_same(x, self.gates.weight[:, :self.x_ch],
                          self.gates.bias, self.dtype)

    def project_zero(self) -> torch.Tensor:
        """A free-run's projection: the conv of zeros is the bias."""
        return self.gates.bias.to(self.dtype).reshape(1, 1, 1, -1)

    def step_fused(self, carry: Carry, gx: torch.Tensor
                   ) -> Tuple[Carry, torch.Tensor]:
        h, c = carry
        raw = gx + _conv_same(h, self.gates.weight[:, self.x_ch:], None,
                              self.dtype)
        return self._finish(c, raw)

    def _finish(self, c: torch.Tensor, raw: torch.Tensor
                ) -> Tuple[Carry, torch.Tensor]:
        i, f, g, o = self.norm(raw).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return (h_new, c_new), h_new


def scan_cell(cell: ConvLSTMCell, carry: Carry, xs: Optional[torch.Tensor],
              length: int, fused: bool = True
              ) -> Tuple[Carry, torch.Tensor]:
    """Run ``cell`` over xs (B, T, H, W, C), or free-run it for
    ``length`` steps where xs is None. Returns (the last carry, hiddens
    (B, T, H, W, F))."""
    if fused and xs is None:
        steps = [cell.project_zero()] * length
    elif fused:
        b, t = xs.shape[:2]
        gx = cell.project_x(xs.reshape(b * t, *xs.shape[2:]))
        steps = gx.reshape(b, t, *gx.shape[1:]).unbind(1)
    else:
        steps = [None] * length if xs is None else xs.unbind(1)
    hs = []
    for step in steps:
        carry, h = (cell.step_fused(carry, step) if fused
                    else cell(carry, step))
        hs.append(h)
    return carry, torch.stack(hs, dim=1)


# ((conv out_ch, kernel, stride), cell features) of each encoder stage,
# and (out_ch, kernel, stride) of each deconv between forecaster stages.
ENCODER_STAGES = (((16, 3, 2), 64), ((64, 3, 2), 96), ((96, 3, 2), 96))
DECODER_DECONVS = ((96, 4, 2), (96, 4, 2))


class ConvLSTMED(nn.Module):
    def __init__(self, in_channels: int = 1,
                 encoder_stages: Sequence = ENCODER_STAGES,
                 decoder_deconvs: Sequence = DECODER_DECONVS, *,
                 fused: bool = True, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.in_channels, self.dtype, self.fused = in_channels, dtype, fused
        self.n_enc, self.n_deconv = len(encoder_stages), len(decoder_deconvs)
        if any((k, s) != (4, 2) for _, k, s in decoder_deconvs):
            raise NotImplementedError("the forecaster's deconvs are 4x4 at "
                                      "stride 2 ('SAME')")
        cin = in_channels
        for si, ((f_out, k, s), feats) in enumerate(encoder_stages):
            self.add_module(f"enc_conv_{si}", Conv(
                cin, f_out, k, stride=s, padding=1, **kw))
            self.add_module(f"enc_cell_{si}", ConvLSTMCell(f_out, feats,
                                                           **kw))
            cin = feats
        feats = [st[1] for st in encoder_stages][::-1]
        y_ch = None
        for si, f in enumerate(feats):
            self.add_module(f"dec_cell_{si}", ConvLSTMCell(
                f if y_ch is None else y_ch, f, **kw))
            if si < self.n_deconv:
                y_ch = decoder_deconvs[si][0]
                self.add_module(f"dec_deconv_{si}",
                                ConvTranspose(f, y_ch, **kw))
        self.head_deconv = ConvTranspose(feats[-1], 64, **kw)
        self.head_conv_0 = Conv(64, 16, 3, padding=1, **kw)
        self.head_conv_1 = Conv(16, in_channels, 1, **kw)

    def predict(self, batch: Dict[str, torch.Tensor], generator=None
                ) -> Tuple[torch.Tensor, Dict]:
        """(B, n_out, H, W, C) in (0, 1), and no stats. Draws nothing."""
        x = batch["observed_data"].to(self.dtype) + 0.5
        b, t_in = x.shape[:2]
        n_out = batch["tp_to_predict"].shape[0]
        flat = lambda v: v.reshape(v.shape[0] * v.shape[1], *v.shape[2:])
        states = []
        for si in range(self.n_enc):
            y = leaky_relu(getattr(self, f"enc_conv_{si}")(flat(x)), 0.2)
            y = y.reshape(b, t_in, *y.shape[1:])
            cell = getattr(self, f"enc_cell_{si}")
            zero = torch.zeros((b, *y.shape[2:4], cell.num_features),
                               dtype=self.dtype, device=y.device)
            carry, x = scan_cell(cell, (zero, zero), y, t_in, self.fused)
            states.append(carry)
        y = None
        for si, carry in enumerate(states[::-1]):
            _, hs = scan_cell(getattr(self, f"dec_cell_{si}"), carry, y,
                              n_out, self.fused)
            if si < self.n_deconv:
                out = leaky_relu(getattr(self, f"dec_deconv_{si}")(flat(hs)),
                                 0.2)
            else:
                out = leaky_relu(self.head_deconv(flat(hs)), 0.2)
                out = leaky_relu(self.head_conv_0(out), 0.2)
                out = self.head_conv_1(out)
            y = out.reshape(b, n_out, *out.shape[1:])
        return torch.sigmoid(y).float(), {}

    def loss(self, batch: Dict[str, torch.Tensor], generator=None):
        pred, _ = self.predict(batch)
        target = batch["data_to_predict"].float() + 0.5
        mse = torch.mean(torch.square(pred - target))
        return mse, ({"loss": mse, "mse": mse}, pred)
