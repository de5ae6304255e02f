"""S3VAE's frame stacks, recurrent heads and DFP head.

Counterpart of ``ode_rl_tpu/nn/s3vae_nets.py``:

* ``FrameEncoder``: conv stacks with BatchNorm (nn/norm.py, flax's
  numbers) and leaky_relu 0.2, then a tanh: 'default' 64x64 -> 1x1,
  'odecgru'/'cgru'/'cgru_rim' -> 1/16 of the frame, 'cgru_sa' -> 1/8;
* ``FrameDecoder``: 'default' starts with ``deconv_in``, a VALID 4x4
  transposed conv (1x1 -> 4x4; the weight is flax's kernel flipped,
  (in, out, 4, 4), for ``conv_transpose2d(stride=1, padding=0)``); the
  others with a 3x3 conv; then 2x nearest upsamples (exact as a repeat)
  and 3x3 convs with BatchNorm and relu, and a 1x1 conv out;
* ``GRUEncoder``: the vector heads on flax's GRU (nn/dense.py): static
  (last hidden -> mean, softplus std), dynamic (a second GRU, or a RIM,
  free-running from the posterior's last hidden on a constant input of
  ones) and prior (over the posterior's (mean, std) sequence);
* ``ConvGRUEncoderS3``: the spatial heads: a ConvGRU (nn/convgru.py, so
  kernels K3/K4 on the card) or a conv-RIM over the frames, then per
  step the ``_ConvHead`` mean and log-variance nets; the dynamic head
  free-runs a second cell; in 'odecgru' mode it is the ODE-ConvGRU z0
  (nn/odeconvgru.py) and a dopri5 rollout of a ``ConvNet`` field over
  arange(out_seq) / out_seq (kernels K1/K2 on the card), 64 steps at most;
* ``DFP``: the motion-grid logits of the transitions (the sigmoid is the
  loss's).

Every module that holds a BatchNorm or a dropout takes ``train``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.core.noise import Noise
from ode_rl_torch.nn.conv_stacks import Conv, ConvNet, leaky_relu, lecun_normal
from ode_rl_torch.nn.convgru import ConvGRUCell, convgru_freerun, convgru_scan
from ode_rl_torch.nn.dense import GRU, Dense
from ode_rl_torch.nn.norm import BatchNorm
from ode_rl_torch.nn.odeconvgru import ODEConvGRUEncoder
from ode_rl_torch.nn.rims import RIM, ConvRIM
from ode_rl_torch.ode.solvers import odeint_aux

# (features, kernel, stride, padding) of each encoder's conv_i; then its
# conv_out's (kernel, stride, padding).
_ENCODER_PLANS = {
    "default": ([(64, 4, 2, 1), (128, 4, 2, 1), (256, 4, 2, 1),
                 (512, 4, 2, 1)], (4, 1, 0)),
    "cgru": ([(16, 4, 2, 1), (32, 4, 2, 1), (64, 4, 2, 1)], (4, 2, 1)),
    "cgru_sa": ([(16, 3, 2, 1), (32, 3, 2, 1), (64, 3, 1, 1)], (3, 2, 1)),
}
_ENCODER_PLANS["odecgru"] = _ENCODER_PLANS["cgru_rim"] = _ENCODER_PLANS[
    "cgru"]
# The decoders' conv_i widths, each after a 2x upsample.
_DECODER_PLANS = {"default": [256, 128, 128, 64],
                  "cgru": [256, 128, 128, 64], "cgru_sa": [256, 128, 64]}
_DECODER_PLANS["odecgru"] = _DECODER_PLANS["cgru_rim"] = _DECODER_PLANS[
    "cgru"]


def _check_encoder(encoder_type: str) -> None:
    if encoder_type not in _ENCODER_PLANS:
        raise NotImplementedError(encoder_type)


class FrameEncoder(nn.Module):
    def __init__(self, in_ch: int, encoder_type: str = "default",
                 out_dims: int = 128, *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        _check_encoder(encoder_type)
        plan, (k, s, p) = _ENCODER_PLANS[encoder_type]
        kw = dict(dtype=dtype, generator=generator)
        self.n = len(plan)
        cin = in_ch
        for i, (f, kk, ss, pp) in enumerate(plan):
            self.add_module(f"conv_{i}", Conv(cin, f, kk, stride=ss,
                                              padding=pp, **kw))
            self.add_module(f"bn_{i}", BatchNorm(f))
            cin = f
        self.conv_out = Conv(cin, out_dims, k, stride=s, padding=p, **kw)
        self.bn_out = BatchNorm(out_dims)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(x), train)
            x = leaky_relu(x, 0.2)
        return torch.tanh(self.bn_out(self.conv_out(x), train))


class ConvTransposeStride1(nn.Module):
    """``nn.ConvTranspose(features, (k, k))`` at stride 1: with
    ``padding`` 0 flax's 'VALID' (an (H, W) map becomes (H + k - 1,
    W + k - 1)), with (k - 1) // 2 its 'SAME' for an odd k. The weight is
    (in, out, k, k), flax's kernel flipped (convert.py)."""

    def __init__(self, cin: int, cout: int, k: int = 4, *, padding: int = 0,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.dtype, self.padding = dtype, padding
        self.weight = lecun_normal((cin, cout, k, k), k * k * cin, generator)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2),
                               self.weight.to(self.dtype),
                               padding=self.padding)
        return y.permute(0, 2, 3, 1).contiguous() + self.bias.to(self.dtype)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of NHWC: ``jax.image.resize(..., 'nearest')``
    at an exact factor of 2 repeats each pixel."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class FrameDecoder(nn.Module):
    def __init__(self, in_ch: int, encoder_type: str = "default",
                 final_dim: int = 1, *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        _check_encoder(encoder_type)
        kw = dict(dtype=dtype, generator=generator)
        self.default = encoder_type == "default"
        if self.default:
            self.deconv_in = ConvTransposeStride1(in_ch, 512, **kw)
            cin = 512
        else:
            self.conv_in = Conv(in_ch, 256, 3, padding=1, **kw)
            cin = 256
        self.bn_in = BatchNorm(cin)
        plan = _DECODER_PLANS[encoder_type]
        self.n = len(plan)
        for i, f in enumerate(plan):
            self.add_module(f"conv_{i}", Conv(cin, f, 3, padding=1, **kw))
            self.add_module(f"bn_{i}", BatchNorm(f))
            cin = f
        self.conv_out = Conv(cin, final_dim, 1, **kw)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = self.deconv_in(x) if self.default else self.conv_in(x)
        x = F.relu(self.bn_in(x, train))
        for i in range(self.n):
            x = getattr(self, f"conv_{i}")(upsample2(x))
            x = F.relu(getattr(self, f"bn_{i}")(x, train))
        return self.conv_out(x)


class GRUEncoder(nn.Module):
    """The vector heads; ``head_type`` static | dynamic | prior."""

    def __init__(self, din: int, hidden: int, z_size: int,
                 head_type: str = "static", *, rim: bool = False,
                 num_rims: int = 1, generator: torch.Generator):
        super().__init__()
        kw = dict(generator=generator)
        self.head_type, self.use_rim = head_type, rim
        self.num_rims, self.hidden = num_rims, hidden
        self.gru = GRU(din, hidden, **kw)
        head_in = hidden
        if head_type == "dynamic" and rim:
            # Its own 3 blocks, all active: the config's num_blocks and
            # topk reach only the 'cgru_rim' encoder (as in JAX).
            self.rim = RIM(hidden, [hidden], [3], [3], **kw)
            head_in = hidden // num_rims
        elif head_type == "dynamic":
            self.dynamic_gru = GRU(hidden, hidden, **kw)
        self.mean = Dense(head_in, z_size, **kw)
        self.std = Dense(head_in, z_size, **kw)

    def _heads(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.mean(x), F.softplus(self.std(x))

    def forward(self, xs: torch.Tensor, out_seq: Optional[int] = None,
                train: bool = True, noise: Optional[Noise] = None):
        outs, hidden = self.gru(xs)
        if self.head_type == "static":
            return self._heads(hidden)
        if self.head_type == "prior":
            return self._heads(outs)
        b = xs.shape[0]
        ones = torch.ones((b, out_seq, self.hidden), dtype=xs.dtype,
                          device=xs.device)
        if self.use_rim:
            dyn, _ = self.rim(ones, h0=[hidden], train=train, noise=noise)
            unit = self.hidden // self.num_rims
            dyn = dyn.reshape(b, out_seq, unit, self.num_rims).transpose(2, 3)
            mean, std = self._heads(dyn)          # (B, T, num_rims, z)
            return (mean.transpose(2, 3).reshape(b, out_seq, -1),
                    std.transpose(2, 3).reshape(b, out_seq, -1))
        dyn_outs, _ = self.dynamic_gru(ones, hidden)
        return self._heads(dyn_outs)


class _ConvHead(nn.Module):
    """conv(out -> out) relu conv(out -> 128) relu conv(128 -> out)."""

    def __init__(self, out_ch: int, *, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(padding=1, dtype=dtype, generator=generator)
        self.c0 = Conv(out_ch, out_ch, 3, **kw)
        self.c1 = Conv(out_ch, 128, 3, **kw)
        self.c2 = Conv(128, out_ch, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c2(F.relu(self.c1(F.relu(self.c0(x)))))


class ConvGRUEncoderS3(nn.Module):
    """The spatial heads; ``mode`` cgru | cgru_sa | odecgru | cgru_rim."""

    # The 'odecgru' rollout's solver.
    RTOL, ATOL, MAX_STEPS = 1e-4, 1e-5, 64

    def __init__(self, in_ch: int, out_ch: int, head_type: str = "static",
                 mode: str = "cgru", *, rim_num_blocks: int = 4,
                 rim_topk: int = 3, ode_n_units: int = 64,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.head_type, self.mode, self.dtype = head_type, mode, dtype
        self.out_ch = out_ch
        self.mean_net = _ConvHead(out_ch, **kw)
        self.logvar_net = _ConvHead(out_ch, **kw)
        self.ode = mode == "odecgru" and head_type == "dynamic"
        rim_kw = dict(generator=generator)
        if self.ode:
            self.ode_z0 = ODEConvGRUEncoder(in_ch, out_ch=out_ch,
                                            ode_n_units=ode_n_units, **kw)
            self.ode_func = ConvNet(out_ch, out_ch, n_layers=3,
                                    n_units=ode_n_units, **kw)
            return
        if mode == "cgru_rim":
            self.cgru_rim = ConvRIM(in_ch, out_ch, rim_num_blocks, rim_topk,
                                    **rim_kw)
            if head_type == "dynamic":
                self.dynamic_rim = ConvRIM(in_ch, out_ch, rim_num_blocks,
                                           rim_topk, **rim_kw)
            return
        self.cgru_cell = ConvGRUCell(in_ch, out_ch, kernel_size=5, **kw)
        if head_type == "dynamic":
            self.dynamic_cell = ConvGRUCell(out_ch, out_ch, kernel_size=5,
                                            **kw)

    def _per_step(self, hiddens: torch.Tensor):
        b, t = hiddens.shape[:2]
        flat = hiddens.reshape(b * t, *hiddens.shape[2:])
        return (self.mean_net(flat).reshape(b, t, *flat.shape[1:3], -1),
                self.logvar_net(flat).reshape(b, t, *flat.shape[1:3], -1))

    def forward(self, xs: torch.Tensor, out_seq: Optional[int] = None,
                timesteps: Optional[torch.Tensor] = None, train: bool = True,
                noise: Optional[Noise] = None):
        b, t, h, w, _ = xs.shape
        if self.ode:
            ts_in = (timesteps if timesteps is not None else torch.arange(
                t, dtype=torch.float32, device=xs.device) / t)
            mu0, _ = self.ode_z0(xs, ts_in)
            ts_out = torch.arange(out_seq, dtype=torch.float32) / out_seq
            ys, _ = odeint_aux(lambda tt, y: self.ode_func(y), mu0, ts_out,
                               rtol=self.RTOL, atol=self.ATOL,
                               max_steps=self.MAX_STEPS)
            return self._per_step(ys.movedim(0, 1))
        if self.mode == "cgru_rim":
            hiddens, hidden, _ = self.cgru_rim(xs, train=train, noise=noise)
        else:
            h0 = torch.zeros((b, h, w, self.out_ch), dtype=self.dtype,
                             device=xs.device)
            hiddens, hidden = convgru_scan(self.cgru_cell, h0, xs)
        if self.head_type == "static":
            return self.mean_net(hidden), self.logvar_net(hidden)
        if self.head_type == "dynamic" and self.mode == "cgru_rim":
            ones = torch.ones((b, out_seq, *xs.shape[2:]), dtype=xs.dtype,
                              device=xs.device)
            hiddens, _, _ = self.dynamic_rim(ones, h0=hidden, train=train,
                                             noise=noise)
        elif self.head_type == "dynamic":
            hiddens, _ = convgru_freerun(self.dynamic_cell, hidden, out_seq)
        return self._per_step(hiddens)


class DFP(nn.Module):
    """z_t -> motion-grid logits of the T - 1 transitions: three Denses on
    vectors; on maps three stride-2 3x3 convs, a spatial mean and two
    Denses."""

    def __init__(self, z_in: int, z_size: int, grids: int = 9,
                 spatial: bool = False, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.spatial, self.grids = spatial, grids
        kw = dict(generator=generator)
        if spatial:
            conv = dict(stride=2, padding=1, dtype=dtype, **kw)
            self.c0 = Conv(z_in, 64, 3, **conv)
            self.c1 = Conv(64, 64, 3, **conv)
            self.c2 = Conv(64, 64, 3, **conv)
            self.l0 = Dense(64, 32, **kw)
            self.l1 = Dense(32, grids, **kw)
        else:
            self.l0 = Dense(z_in, z_size, **kw)
            self.l1 = Dense(z_size, z_size, **kw)
            self.l2 = Dense(z_size, grids, **kw)

    def forward(self, zt: torch.Tensor) -> torch.Tensor:
        if self.spatial:
            b, t = zt.shape[:2]
            x = zt[:, 1:].reshape(b * (t - 1), *zt.shape[2:])
            x = self.c2(self.c1(self.c0(x))).mean(dim=(1, 2))
            return self.l1(self.l0(x)).reshape(b, t - 1, self.grids)
        return self.l2(self.l1(self.l0(zt[:, 1:])))
