"""Slot Attention.

Counterpart of ``SlotAttention``, ``SlotAttentionAutoEncoder`` and
``spatial_broadcast`` in ``ode_rl_tpu/nn/slot_attention.py``: iterative
attention with k/q/v projections (q scaled by slot_size^-0.5, softmax
over the slots, epsilon-renormalised weighted mean), a GRU update of
every slot (flax's ``GRUCell``, nn/dense.py, with the slots folded into
the batch), and a residual MLP. The slots start at ``slots_mu +
exp(slots_log_sigma) * noise``: both are learnable parameters, and the
noise is one (B, S, D) draw from the caller's ``Noise``
(core/noise.py). The autoencoder wrapper adds JAX's LayerNorm + MLP
preprocessing; a feature map (B, H, W, C) becomes a set of H*W elements,
a vector (B, C) a set of one. ``SoftPositionEmbed`` adds a Dense
projection of the [y, x, 1 - y, 1 - x] grid to a feature map (Vid-ODE's
slot encoder); the grid is ``linspace(0, 1, n)`` rounded once from fp64,
within an fp32 ulp of ``jnp.linspace``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.core.noise import Noise
from ode_rl_torch.nn.dense import Dense, GRUCell
from ode_rl_torch.nn.norm import LayerNorm
from ode_rl_torch.ops.warp import linspace


def _xavier_uniform(d: int, generator: torch.Generator) -> nn.Parameter:
    """flax's ``xavier_uniform()`` for a (1, 1, d) parameter: fan_in 1,
    fan_out d."""
    limit = math.sqrt(6.0 / (1 + d))
    w = torch.rand((1, 1, d), generator=generator) * 2 * limit - limit
    return nn.Parameter(w)


class SlotAttention(nn.Module):
    EPSILON = 1e-8

    def __init__(self, d_in: int, num_slots: int = 3,
                 num_iterations: int = 3, slot_size: int = 128, *,
                 mlp_hidden: int = 128, generator: torch.Generator):
        super().__init__()
        d = slot_size
        self.num_slots, self.num_iterations = num_slots, num_iterations
        self.slot_size = d
        kw = dict(generator=generator)
        self.norm_inputs = LayerNorm(d_in)
        self.project_k = Dense(d_in, d, use_bias=False, **kw)
        self.project_v = Dense(d_in, d, use_bias=False, **kw)
        self.slots_mu = _xavier_uniform(d, generator)
        self.slots_log_sigma = _xavier_uniform(d, generator)
        self.gru = GRUCell(d, d, **kw)
        self.norm_slots = LayerNorm(d)
        self.norm_mlp = LayerNorm(d)
        self.project_q = Dense(d, d, use_bias=False, **kw)
        self.mlp_0 = Dense(d, mlp_hidden, **kw)
        self.mlp_1 = Dense(mlp_hidden, d, **kw)

    def forward(self, x: torch.Tensor, noise: Optional[Noise] = None,
                init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, N, d_in) -> slots (B, S, slot_size). The slots' initial
        noise is ``init_noise`` (B, S, slot_size) where given, else a
        draw from ``noise``."""
        b, d, s = x.shape[0], self.slot_size, self.num_slots
        x = self.norm_inputs(x)
        k = self.project_k(x)
        v = self.project_v(x)
        init = (noise.normal((b, s, d), x) if init_noise is None
                else init_noise.to(x.dtype))
        slots = self.slots_mu + torch.exp(self.slots_log_sigma) * init
        for _ in range(self.num_iterations):
            slots_prev = slots
            q = self.project_q(self.norm_slots(slots)) * d ** -0.5
            attn = torch.softmax(torch.einsum("bnd,bsd->bns", k, q), dim=-1)
            attn = attn + self.EPSILON
            attn = attn / attn.sum(dim=-2, keepdim=True)
            updates = torch.einsum("bns,bnd->bsd", attn, v)
            slots = self.gru(slots_prev.reshape(b * s, d),
                             updates.reshape(b * s, d)).reshape(b, s, d)
            slots = slots + self.mlp_1(F.relu(self.mlp_0(
                self.norm_mlp(slots))))
        return slots


def spatial_broadcast(slots: torch.Tensor, resolution) -> torch.Tensor:
    """(B, S, D) -> (B*S, H, W, D): each slot broadcast over a grid."""
    b, s, d = slots.shape
    return slots.reshape(b * s, 1, 1, d).expand(
        b * s, resolution[0], resolution[1], d)


class SlotAttentionAutoEncoder(nn.Module):
    """LayerNorm + MLP preprocessing of ``d_features``-wide inputs, then
    SlotAttention. (S3VAE broadcasts the slots itself; JAX's
    ``broadcast_hw`` has no caller.)"""

    def __init__(self, d_features: int, num_slots: int = 3,
                 num_iterations: int = 3, slot_size: int = 128, *,
                 conv_input: bool = False, generator: torch.Generator):
        super().__init__()
        self.conv_input = conv_input
        self.pre_norm = LayerNorm(d_features)
        self.pre_mlp_0 = Dense(d_features, d_features, generator=generator)
        self.pre_mlp_1 = Dense(d_features, d_features, generator=generator)
        self.slot_attention = SlotAttention(
            d_features, num_slots=num_slots, num_iterations=num_iterations,
            slot_size=slot_size, generator=generator)

    def forward(self, x: torch.Tensor, noise: Noise) -> torch.Tensor:
        if self.conv_input:
            b, h, w, c = x.shape
            x = x.reshape(b, h * w, c)
        elif x.ndim == 2:
            x = x[:, None, :]                  # a set of one element
        x = self.pre_mlp_1(F.relu(self.pre_mlp_0(self.pre_norm(x))))
        return self.slot_attention(x, noise)


class SoftPositionEmbed(nn.Module):
    """x (..., H, W, C) + Dense(4 -> C) of the grid [y, x, 1 - y, 1 - x],
    y and x each ``linspace(0, 1, n)``."""

    def __init__(self, hidden_size: int, *, generator: torch.Generator):
        super().__init__()
        self.dense = Dense(4, hidden_size, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-3], x.shape[-2]
        gy, gx = torch.meshgrid(linspace(0.0, 1.0, h, x.device),
                                linspace(0.0, 1.0, w, x.device),
                                indexing="ij")
        grid = torch.stack([gy, gx, 1.0 - gy, 1.0 - gx], dim=-1)
        return x + self.dense(grid.to(x.dtype))
