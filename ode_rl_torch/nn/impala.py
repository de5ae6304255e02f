"""The IMPALA residual CNN.

Counterpart of ``ode_rl_tpu/nn/impala.py``: blocks of conv, 3x3 max
pool at stride 2, and two residual units (each two 3x3 convs with ReLU
pre-activation), at depths (16, 32, 64, 128), then a ReLU and an
optional flatten + Dense head. NHWC in and out.

flax's ``max_pool((3, 3), strides=(2, 2), padding="SAME")`` pads with
-inf by (total // 2, total - total // 2), where total = max((ceil(n / 2)
- 1) * 2 + 3 - n, 0): (0, 1) on an even side and (1, 1) on an odd one.
``max_pool2d(padding=1)`` would pad (1, 1) everywhere and shift every
window of an even side, so the pad is explicit. The head flattens the
NHWC map, as flax does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.nn.conv_stacks import Conv
from ode_rl_torch.nn.dense import Dense


def _same_pads(n: int) -> tuple:
    total = max(((n + 1) // 2 - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax's 3x3 stride-2 'SAME' max pool of an NHWC map."""
    (top, bottom), (left, right) = _same_pads(x.shape[1]), _same_pads(
        x.shape[2])
    y = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom),
              value=float("-inf"))
    return F.max_pool2d(y, 3, stride=2).permute(0, 2, 3, 1).contiguous()


class _ResidualUnit(nn.Module):
    def __init__(self, ch: int, *, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(padding=1, dtype=dtype, generator=generator)
        self.c0 = Conv(ch, ch, 3, **kw)
        self.c1 = Conv(ch, ch, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.c1(torch.relu(self.c0(torch.relu(x))))


class ImpalaCNN(nn.Module):
    def __init__(self, in_channels: int, depths: Sequence[int] = (16, 32, 64,
                                                                  128),
                 out_features: Optional[int] = None,
                 in_hw: Optional[Sequence[int]] = None, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        """``in_hw`` (H, W) sizes the head's input where ``out_features``
        asks for one."""
        super().__init__()
        self.n_blocks = len(depths)
        cin = in_channels
        for bi, ch in enumerate(depths):
            self.add_module(f"block{bi}_conv", Conv(
                cin, ch, 3, padding=1, dtype=dtype, generator=generator))
            for r in range(2):
                self.add_module(f"block{bi}_res{r}", _ResidualUnit(
                    ch, dtype=dtype, generator=generator))
            cin = ch
        self.fc = None
        if out_features is not None:
            if in_hw is None:
                raise ValueError("the Dense head needs in_hw to size its "
                                 "input")
            h, w = in_hw
            for _ in depths:
                h, w = (h + 1) // 2, (w + 1) // 2
            self.fc = Dense(h * w * cin, out_features, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for bi in range(self.n_blocks):
            x = getattr(self, f"block{bi}_conv")(x)
            x = max_pool_same(x)
            x = getattr(self, f"block{bi}_res0")(x)
            x = getattr(self, f"block{bi}_res1")(x)
        x = torch.relu(x)
        if self.fc is not None:
            x = torch.relu(self.fc(x.reshape(x.shape[0], -1)))
        return x
