"""Dense layers and the GRU with flax's parameters.

``Dense`` is ``flax.linen.Dense``: a (din, dout) ``kernel`` (flax's
layout, lecun-normal) and a zero ``bias``; y = x @ kernel + bias.

``GRUCell`` is ``flax.linen.GRUCell``, not ``torch.nn.GRUCell``: input
Denses ``ir``, ``iz``, ``in`` with biases, hidden Denses ``hr``, ``hz``
without and ``hn`` with one (orthogonal kernels), and

    r = sigmoid(ir(x) + hr(h));  z = sigmoid(iz(x) + hz(h))
    n = tanh(in(x) + r * hn(h)); h' = (1 - z) * n + z * h.

torch's GRU carries hidden biases on r and z as parameters of their own;
they would train as a second copy of the input biases, so the cell keeps
flax's parameters only. ``GRU`` runs the cell over a (B, T, F) sequence
the way JAX's ``_GRU`` does: the input projections of every step as one
matmul before the loop, only the hidden matmul inside it.

``LSTMCell`` is ``flax.linen.OptimizedLSTMCell``, not
``torch.nn.LSTMCell``: input Denses ``ii``, ``if``, ``ig``, ``io``
without biases (lecun-normal), hidden Denses ``hi``, ``hf``, ``hg``,
``ho`` with them (orthogonal), gates in the order i, f, g, o, no forget
bias, and the carry (c, h):

    i, f, o = sigmoid(h_k(h) + i_k(x));  g = tanh(hg(h) + ig(x))
    c' = f * c + i * g;  h' = o * tanh(c').

``LSTM`` runs it over a (B, T, F) sequence as JAX's ``sprite/dsvae.py``
``_LSTM`` does (the cell's parameters under ``cell``, the input
projections hoisted), back to front where ``reverse``, each output at
its input's position.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ode_rl_torch.nn.conv_stacks import lecun_normal


class Dense(nn.Module):
    def __init__(self, din: int, dout: int, *, use_bias: bool = True,
                 generator: torch.Generator):
        super().__init__()
        self.kernel = lecun_normal((din, dout), din, generator)
        self.bias = nn.Parameter(torch.zeros(dout)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel.to(x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)


def _orthogonal(n: int, generator: torch.Generator) -> nn.Parameter:
    w = torch.empty(n, n)
    nn.init.orthogonal_(w, generator=generator)
    return nn.Parameter(w)


class _HiddenDense(nn.Module):
    """A hidden-side Dense: orthogonal (H, H) kernel."""

    def __init__(self, hidden: int, use_bias: bool,
                 generator: torch.Generator):
        super().__init__()
        self.kernel = _orthogonal(hidden, generator)
        self.bias = nn.Parameter(torch.zeros(hidden)) if use_bias else None


class GRUCell(nn.Module):
    def __init__(self, din: int, hidden: int, *, generator: torch.Generator):
        super().__init__()
        self.hidden = hidden
        for name in ("ir", "iz", "in"):
            self.add_module(name, Dense(din, hidden, generator=generator))
        self.hr = _HiddenDense(hidden, False, generator)
        self.hz = _HiddenDense(hidden, False, generator)
        self.hn = _HiddenDense(hidden, True, generator)

    def input_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(din, 3H) kernel and (3H,) bias of [ir | iz | in]."""
        dense = [getattr(self, n) for n in ("ir", "iz", "in")]
        return (torch.cat([d.kernel for d in dense], dim=-1),
                torch.cat([d.bias for d in dense], dim=-1))

    def step(self, h: torch.Tensor, xp: torch.Tensor, w_h: torch.Tensor,
             b_hn: torch.Tensor) -> torch.Tensor:
        """One step given the input projection ``xp`` (B, 3H) and the
        hidden kernels [hr | hz | hn] (H, 3H)."""
        xr, xz, xn = xp.chunk(3, dim=-1)
        hr, hz, hn = (h @ w_h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * (hn + b_hn))
        return (1.0 - z) * n + z * h

    def hidden_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.cat([self.hr.kernel, self.hz.kernel, self.hn.kernel],
                          dim=-1), self.hn.bias)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One step: (carry h (B, H), input x (B, din)) -> h'."""
        w_i, b_i = self.input_weights()
        return self.step(h, x @ w_i + b_i, *self.hidden_weights())


class GRU(nn.Module):
    """Unidirectional GRU over (B, T, F) -> (outputs (B, T, H), the last
    hidden); the cell's parameters live under ``cell``."""

    def __init__(self, din: int, hidden: int, *, generator: torch.Generator):
        super().__init__()
        self.hidden = hidden
        self.cell = GRUCell(din, hidden, generator=generator)

    def forward(self, xs: torch.Tensor, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t = xs.shape[:2]
        h = (torch.zeros((b, self.hidden), dtype=xs.dtype, device=xs.device)
             if h0 is None else h0)
        w_i, b_i = self.cell.input_weights()
        x_proj = xs @ w_i + b_i                     # (B, T, 3H), one matmul
        w_h, b_hn = self.cell.hidden_weights()
        outs = []
        for i in range(t):
            h = self.cell.step(h, x_proj[:, i], w_h, b_hn)
            outs.append(h)
        return torch.stack(outs, dim=1), h


_LSTM_GATES = "ifgo"


class LSTMCell(nn.Module):
    def __init__(self, din: int, hidden: int, *, generator: torch.Generator):
        super().__init__()
        self.hidden = hidden
        for k in _LSTM_GATES:
            self.add_module(f"i{k}", Dense(din, hidden, use_bias=False,
                                           generator=generator))
        for k in _LSTM_GATES:
            self.add_module(f"h{k}", _HiddenDense(hidden, True, generator))

    def input_kernel(self) -> torch.Tensor:
        """(din, 4H): [ii | if | ig | io]."""
        return torch.cat([getattr(self, f"i{k}").kernel
                          for k in _LSTM_GATES], dim=-1)

    def hidden_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(H, 4H) kernel and (4H,) bias of [hi | hf | hg | ho]."""
        dense = [getattr(self, f"h{k}") for k in _LSTM_GATES]
        return (torch.cat([d.kernel for d in dense], dim=-1),
                torch.cat([d.bias for d in dense], dim=-1))

    @staticmethod
    def step(c: torch.Tensor, h: torch.Tensor, xp: torch.Tensor,
             w_h: torch.Tensor, b_h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step given the input projection ``xp`` (B, 4H)."""
        hi, hf, hg, ho = (h @ w_h + b_h).chunk(4, dim=-1)
        xi, xf, xg, xo = xp.chunk(4, dim=-1)
        c = torch.sigmoid(hf + xf) * c + torch.sigmoid(hi + xi) * torch.tanh(
            hg + xg)
        return c, torch.sigmoid(ho + xo) * torch.tanh(c)

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor],
                x: torch.Tensor):
        """((c, h), x (B, din)) -> ((c', h'), h')."""
        c, h = self.step(*carry, x @ self.input_kernel(),
                         *self.hidden_weights())
        return (c, h), h


class LSTM(nn.Module):
    """(B, T, F) -> outputs (B, T, H) from zero states."""

    def __init__(self, din: int, hidden: int, *, reverse: bool = False,
                 generator: torch.Generator):
        super().__init__()
        self.hidden, self.reverse = hidden, reverse
        self.cell = LSTMCell(din, hidden, generator=generator)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        b, t = xs.shape[:2]
        c = h = torch.zeros((b, self.hidden), dtype=xs.dtype,
                            device=xs.device)
        x_proj = xs @ self.cell.input_kernel()          # (B, T, 4H)
        w_h, b_h = self.cell.hidden_weights()
        outs = [None] * t
        for i in (range(t - 1, -1, -1) if self.reverse else range(t)):
            c, h = self.cell.step(c, h, x_proj[:, i], w_h, b_h)
            outs[i] = h
        return torch.stack(outs, dim=1)
