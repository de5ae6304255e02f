"""The random draws of a model, all from one explicit generator.

JAX draws a model's noise from its 'sample' and 'dropout' rngs; the port
draws each from the ``torch.Generator`` the caller passes, through this
object, so one place says what is drawn and in what order. A test that
holds a model to JAX replaces it with one that hands out given arrays in
the order they are asked for.

Under data parallelism (parallel/mesh.py) a rank's draws are rows of the
unsharded step's: ``GlobalRows`` makes every draw at the global batch's
shape, from the same generator on every rank, and keeps the rank's rows
of its batch axis (axis 0 unless the caller names another through
``normal_at``). Permutations are drawn whole; S3VAE permutes the global
batch itself.
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

    def normal_at(self, shape: Sequence[int], like: torch.Tensor,
                  batch_axis: int) -> torch.Tensor:
        """``normal`` of a shape whose batch axis is ``batch_axis``."""
        return self.normal(shape, like)

    def in_blocks(self, blocks: int) -> "Noise":
        """The draws of a pass over ``blocks`` batches stacked on axis 0
        (S3VAE's anchor, positive and negative rows)."""
        return self

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
        return torch.where(self._keep_mask(x.shape, keep, x.device), x / keep,
                           torch.zeros_like(x))

    def _keep_mask(self, shape: Sequence[int], keep: float,
                   device: torch.device) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=device) < keep


class GlobalRows(Noise):
    """``inner``'s draws at the global batch (``world`` shards of the
    shapes asked for), of which this ``rank`` keeps its rows: of each of
    ``blocks`` batches where a pass stacks several on the batch axis."""

    def __init__(self, inner: Noise, rank: int, world: int,
                 blocks: int = 1):
        super().__init__(inner.generator)
        self.inner, self.rank, self.world = inner, rank, world
        self.blocks = blocks

    def in_blocks(self, blocks: int) -> "GlobalRows":
        return GlobalRows(self.inner, self.rank, self.world, blocks)

    def _rows(self, draw, shape: Sequence[int], axis: int = 0):
        shape = tuple(shape)
        if not shape:
            return draw(shape)
        k = self.blocks if axis == 0 else 1
        n = shape[axis] // k
        full = draw(shape[:axis] + (n * k * self.world,) + shape[axis + 1:])
        if k == 1:
            return full.narrow(axis, self.rank * n, n)
        full = full.reshape(k, n * self.world, *shape[1:])
        return full.narrow(1, self.rank * n, n).reshape(shape)

    def permutation(self, n: int, device: torch.device) -> torch.Tensor:
        return self.inner.permutation(n, device)

    def normal(self, shape, like):
        return self._rows(lambda s: self.inner.normal(s, like), shape)

    def normal_at(self, shape, like, batch_axis):
        return self._rows(lambda s: self.inner.normal(s, like), shape,
                          batch_axis)

    def gumbel(self, shape, like):
        return self._rows(lambda s: self.inner.gumbel(s, like), shape)

    def uniform(self, shape, device, low=0.0, high=1.0):
        return self._rows(lambda s: self.inner.uniform(s, device, low, high),
                          shape)

    def randint(self, low, high, shape, device):
        return self._rows(lambda s: self.inner.randint(low, high, s, device),
                          shape)

    def _keep_mask(self, shape, keep, device):
        return self._rows(lambda s: self.inner._keep_mask(s, keep, device),
                          shape)


def global_rows(generator, rank: int, world: int):
    """``generator`` as draws of the unsharded step's rows where ``world``
    > 1; None and one rank pass as they are."""
    if generator is None or world == 1:
        return generator
    return GlobalRows(as_noise(generator, "a sharded step"), rank, world)


def as_noise(generator, what: str) -> Noise:
    """``generator`` as a ``Noise`` (a ``Noise`` passes as it is); raises
    where there is none, naming ``what`` draws from it."""
    if generator is None:
        raise ValueError(f"{what} draws its noise from a generator: pass "
                         "one")
    return generator if isinstance(generator, Noise) else Noise(generator)

