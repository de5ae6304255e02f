"""ControlledDigit, the on-device control task of the Dreamer RL loop.

Counterpart of ``ode_rl_tpu/wm/envs.py``: a 28x28 digit sprite on a
64x64 canvas; the action in [-1, 1]^2 sets its velocity (``SPEED``
pixels a step, the position clipped to [0, 36]); the reward is the
normalised x-position. ``render`` places each sprite at its rounded
position (``torch.round`` rounds half to even, as ``jnp.round``) by
indexing; ``collect_random`` rolls an episode in the world model's
format with a_0 = 0 for the reset observation.

Draws, from the caller's ``Noise``: ``reset`` draws the sprite indices,
then the positions (uniform in [0, 36)); ``collect_random`` draws
``reset``'s, then each step's action (uniform in [-1, 1)), or hands the
step's observation and the noise to ``policy_fn``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ode_rl_torch.core.noise import Noise

SPRITE = 28
CANVAS = 64
POS_MAX = float(CANVAS - SPRITE)   # 36
SPEED = 4.0

EnvState = Dict[str, torch.Tensor]


def reset(noise: Noise, sprite_bank: torch.Tensor, batch: int) -> EnvState:
    """Random sprites at random positions."""
    device = sprite_bank.device
    idx = noise.randint(0, sprite_bank.shape[0], (batch,), device)
    pos = noise.uniform((batch, 2), device, 0.0, POS_MAX)
    return {"idx": idx, "pos": pos}


def render(state: EnvState, sprite_bank: torch.Tensor) -> torch.Tensor:
    """(B, 64, 64, 1) fp32 frames in [-0.5, 0.5]."""
    sprites = sprite_bank[state["idx"]].float() / 255.0
    b = sprites.shape[0]
    device = sprites.device
    corner = torch.clamp(torch.round(state["pos"]).to(torch.int64), 0,
                         CANVAS - SPRITE)
    span = torch.arange(SPRITE, device=device)
    rows = (corner[:, 1, None] + span)[:, :, None]        # (B, 28, 1)
    cols = (corner[:, 0, None] + span)[:, None, :]        # (B, 1, 28)
    frames = torch.zeros((b, CANVAS, CANVAS), device=device)
    frames[torch.arange(b, device=device)[:, None, None], rows, cols] = (
        sprites)
    return frames[..., None] - 0.5


def step(state: EnvState, action: torch.Tensor
         ) -> Tuple[EnvState, torch.Tensor]:
    """pos += SPEED * clip(action) (clipped); reward = x / POS_MAX."""
    pos = torch.clamp(state["pos"] + SPEED * torch.clamp(action, -1.0, 1.0),
                      0.0, POS_MAX)
    return {"idx": state["idx"], "pos": pos}, pos[:, 0] / POS_MAX


def collect_random(noise: Noise, sprite_bank: torch.Tensor, batch: int,
                   horizon: int, policy_fn: Optional[Callable] = None
                   ) -> Dict[str, torch.Tensor]:
    """An episode of ``horizon`` frames: image (B, T, 64, 64, 1), action
    (B, T, 2) with action_t the action that led to obs_t (a_0 = 0), and
    reward (B, T)."""
    device = sprite_bank.device
    state = reset(noise, sprite_bank, batch)
    images = [render(state, sprite_bank)]
    actions = [torch.zeros((batch, 2), device=device)]
    rewards = [state["pos"][:, 0] / POS_MAX]
    for _ in range(horizon - 1):
        if policy_fn is None:
            a = noise.uniform((batch, 2), device, -1.0, 1.0)
        else:
            a = policy_fn(render(state, sprite_bank), noise)
        state, r = step(state, a)
        images.append(render(state, sprite_bank))
        actions.append(a)
        rewards.append(r)
    return {"image": torch.stack(images, 1),
            "action": torch.stack(actions, 1),
            "reward": torch.stack(rewards, 1)}
