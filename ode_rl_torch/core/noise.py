"""The random draws of a model, all from one explicit generator.

JAX draws a model's noise from its 'sample' and 'dropout' rngs; the port
draws each from the ``torch.Generator`` the caller passes, through this
object, so one place says what is drawn and in what order. A test that
holds a model to JAX replaces it with one that hands out given arrays in
the order they are asked for.
"""

from __future__ import annotations

from typing import Sequence

import torch


class Noise:
    """Permutations, standard normals, Gumbels and dropout masks from
    ``generator`` (on the device the draws are made on); uniforms and
    integers (the window samplers' and the video transforms' draws) on
    the generator's device, then moved to ``device``."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def permutation(self, n: int, device: torch.device) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator, device=device)

    def normal(self, shape: Sequence[int], like: torch.Tensor
               ) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           dtype=like.dtype, device=like.device)

    def gumbel(self, shape: Sequence[int], like: torch.Tensor
               ) -> torch.Tensor:
        """Standard Gumbels -log(-log(u)) in ``like``'s dtype, the
        uniforms u clamped below at the dtype's smallest normal, as
        ``jax.random.gumbel`` draws them."""
        u = torch.rand(tuple(shape), generator=self.generator,
                       dtype=like.dtype, device=like.device)
        return -torch.log(-torch.log(u.clamp_min(torch.finfo(like.dtype)
                                                 .tiny)))

    def uniform(self, shape: Sequence[int], device: torch.device,
                low: float = 0.0, high: float = 1.0) -> torch.Tensor:
        """fp32 uniforms in [low, high)."""
        u = torch.rand(tuple(shape), generator=self.generator,
                       device=self.generator.device)
        return (low + (high - low) * u).to(device)

    def randint(self, low: int, high: int, shape: Sequence[int],
                device: torch.device) -> torch.Tensor:
        """int64 integers in [low, high)."""
        return torch.randint(low, high, tuple(shape),
                             generator=self.generator,
                             device=self.generator.device).to(device)

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """``flax.linen.Dropout`` in training: each element kept with
        probability 1 - rate and then scaled by 1 / (1 - rate), a fresh
        mask at every call."""
        if rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def as_noise(generator, what: str) -> Noise:
    """``generator`` as a ``Noise`` (a ``Noise`` passes as it is); raises
    where there is none, naming ``what`` draws from it."""
    if generator is None:
        raise ValueError(f"{what} draws its noise from a generator: pass "
                         "one")
    return generator if isinstance(generator, Noise) else Noise(generator)

