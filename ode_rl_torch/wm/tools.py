"""The Dreamer toolbox.

Counterpart of ``ode_rl_tpu/wm/tools.py``: schedule strings (a constant,
``linear(a,b,steps)``, ``warmup(steps,value)``, ``exp(a,b,halflife)`` and
``horizon(a,b,steps)``), the lambda-return as a reverse loop over time,
the straight-through one-hot sample and the ``Every``/``Once``/``Until``
step gates. A schedule is read at a Python step, so it is a Python float.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F

from ode_rl_torch.core.noise import Noise


def schedule(string, step) -> float:
    """The value of the schedule ``string`` (or a number) at ``step``."""
    step = float(step)
    if isinstance(string, (int, float)):
        return float(string)
    clip01 = lambda v: min(max(v, 0.0), 1.0)
    m = re.match(r"linear\((.+),(.+),(.+)\)", string)
    if m:
        initial, final, duration = map(float, m.groups())
        mix = clip01(step / duration)
        return (1.0 - mix) * initial + mix * final
    m = re.match(r"warmup\((.+),(.+)\)", string)
    if m:
        warmup, value = map(float, m.groups())
        return clip01(step / warmup) * value
    m = re.match(r"exp\((.+),(.+),(.+)\)", string)
    if m:
        initial, final, halflife = map(float, m.groups())
        return (initial - final) * 0.5 ** (step / halflife) + final
    m = re.match(r"horizon\((.+),(.+),(.+)\)", string)
    if m:
        initial, final, duration = map(float, m.groups())
        mix = clip01(step / duration)
        return 1.0 - 1.0 / ((1.0 - mix) * initial + mix * final)
    try:
        return float(string)
    except ValueError as e:
        raise NotImplementedError(string) from e


def lambda_return(reward: torch.Tensor, value: torch.Tensor,
                  pcont: torch.Tensor, bootstrap: torch.Tensor,
                  lambda_: float, axis: int = 0) -> torch.Tensor:
    """V_l(t) = r_t + g_t [(1 - l) v_{t+1} + l V_l(t+1)] along ``axis``,
    from V_l(T) = ``bootstrap``."""
    if axis != 0:
        reward, value, pcont = (torch.movedim(x, axis, 0)
                                for x in (reward, value, pcont))
    next_values = torch.cat([value[1:], bootstrap[None]], dim=0)
    inputs = reward + pcont * next_values * (1.0 - lambda_)
    ret, returns = bootstrap, [None] * reward.shape[0]
    for t in range(reward.shape[0] - 1, -1, -1):
        ret = inputs[t] + pcont[t] * lambda_ * ret
        returns[t] = ret
    out = torch.stack(returns, dim=0)
    return torch.movedim(out, 0, axis) if axis != 0 else out


def one_hot_st_sample(noise: Noise, logits: torch.Tensor) -> torch.Tensor:
    """Straight-through one-hot sample over the last axis: the argmax of
    logits plus one Gumbel draw, then sample + probs - probs.detach()."""
    idx = torch.argmax(logits + noise.gumbel(logits.shape, logits), dim=-1)
    sample = F.one_hot(idx, logits.shape[-1]).to(logits.dtype)
    probs = torch.softmax(logits, dim=-1)
    return sample + probs - probs.detach()


class Every:
    def __init__(self, every: int):
        self._every = every
        self._last = None

    def __call__(self, step: int) -> bool:
        if not self._every:
            return False
        if self._last is None or step >= self._last + self._every:
            self._last = step
            return True
        return False


class Once:
    def __init__(self):
        self._done = False

    def __call__(self) -> bool:
        if self._done:
            return False
        self._done = True
        return True


class Until:
    def __init__(self, until: int):
        self._until = until

    def __call__(self, step: int) -> bool:
        return bool(step < self._until) if self._until else True
