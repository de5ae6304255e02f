"""Height-sharded frames: the ``'space'`` mesh axis.

Counterpart of ``ode_rl_tpu/parallel/sp.py``. JAX shards the frame
height of every (B, T, H, W[, C]) tensor over a ``('data', 'space')``
mesh and GSPMD inserts the halo exchanges that keep each convolution
exact. The port writes them: rank s of a ``'space'`` line of n holds
rows ``[s * H / n, (s + 1) * H / n)`` of every map, and a convolution
first takes the rows its kernel reaches across the cut from its
neighbours (``halo_rows``: zeros at the frame's edges, which are the
convolution's own padding there), then runs on the taller tile with no
padding along H.

``Conv3x3`` (kernels K1/K2) takes no taller tile: its ``space_conv3x3``
hands the kernels the rank's own rows and the two rows across the cuts
as a separate halo operand (``edge_rows``), so their tiles cover the
rank's rows only, and its backward sums the halo rows' share of dx inside
K1 (the cotangent's edge rows exchanged the same way).

The rows a convolution reaches follow from its kernel k, stride s and
padding p along H, on a map whose rows split into equal slices with s
dividing a slice (the output then splits into equal slices as well):

* a convolution's output row o reads input rows o*s - p to o*s - p + k
  - 1, so a slice of output rows needs ``p`` rows above its input slice
  and ``k - s - p`` below (``conv_halo``): 1 and 1 for a 3x3 SAME conv,
  2 and 2 for a 5x5, 0 and 0 for a 1x1, and 1 and 0 for the 3x3 stride-2
  padding-1 convs of the encoders (row 32 of 64 splits them: rank 1
  needs row 31, rank 0 nothing from below);
* a transposed convolution's output row o = i*s - p + kh receives input
  rows i from ceil((o + p - k + 1) / s) to floor((o + p) / s), so a
  slice needs ``-ceil((p - k + 1) / s)`` rows above and ``floor((p - 1) /
  s) + 1`` below, and its output rows start ``top * s + p`` rows into the
  tile's unpadded output (``transposed_halo``): 1, 1 and 3 for the
  decoders' 4x4 stride-2 'SAME' (torch padding 1) transposed convs.

A negative halo crops. The backward of ``halo_rows`` sends each halo
row's gradient to the rank that owns the row, which adds it to its own.
Both directions are one all-gather over the ``'space'`` line of the
boundary rows (gloo's and NCCL's all-gather take CUDA tensors; a
point-to-point send is not needed).

Per-(sample, group) GroupNorm moments span the ranks of a line: kernels
K3 and K4 take the moments summed over ``'space'`` (ops/gru_gates.py),
and dopri5's error norm and the loss's means sum over ``'data'`` x
``'space'`` (parallel/mesh.py).
"""

from __future__ import annotations

import datetime
import math
from typing import Dict, Optional, Tuple

import torch

from ode_rl_torch.ops.conv3x3 import (conv3x3_fwd, conv3x3_wgrad,
                                      flip_transpose)
from ode_rl_torch.parallel.mesh import SPACE_AXIS, Mesh, _grid, axis_mesh

__all__ = ["SPACE_AXIS", "make_sp_mesh", "shard_batch_sp", "shard_video",
           "halo_rows", "conv_halo", "transposed_halo", "space_mesh",
           "edge_rows", "space_conv3x3"]


def make_sp_mesh(n_data: Optional[int] = None, n_space: int = 2,
                 backend: Optional[str] = None,
                 device: Optional[torch.device] = None,
                 init_method: Optional[str] = None,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 timeout: datetime.timedelta = datetime.timedelta(minutes=10)
                 ) -> Mesh:
    """A ``('data', 'space')`` mesh: the batch over ``'data'``, the frame
    height over ``'space'`` (``n_space`` ranks a line). The process group
    as ``make_mesh``'s."""
    return _grid(SPACE_AXIS, n_data, n_space, backend, device, init_method,
                 rank, world_size, timeout)


def _rows_of(n: int, mesh: Mesh, axis: str) -> slice:
    k = mesh.size(axis)
    if n % k:
        raise ValueError(f"{n} rows do not split over {k} {axis!r} ranks")
    i = mesh.index(axis)
    return slice(i * (n // k), (i + 1) * (n // k))


def shard_video(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of B and of H (axis 2) of a (B, T, H, W[, C])
    tensor."""
    x = x[mesh.rows(x.shape[0])]
    return x[:, :, _rows_of(x.shape[2], mesh, SPACE_AXIS)]


def shard_batch_sp(batch: Dict, mesh: Mesh) -> Dict:
    """A batch dict on a ``('data', 'space')`` mesh: video tensors take
    this rank's rows of the batch and of the height, per-sample vectors
    (masks, labels) its rows of the batch, shared arrays (timestamps)
    stay whole."""
    n = batch["observed_data"].shape[0]

    def place(x):
        if not (torch.is_tensor(x) and x.ndim >= 1 and x.shape[0] == n):
            return x
        return shard_video(x, mesh) if x.ndim >= 4 else x[mesh.rows(n)]

    return {k: place(v) for k, v in batch.items()}


def space_mesh() -> Optional[Mesh]:
    """The entered mesh where it splits the height, else None."""
    return axis_mesh(SPACE_AXIS)


def conv_halo(k: int, stride: int, padding: int) -> Tuple[int, int]:
    """(rows from above, rows from below) a convolution's slice needs."""
    return padding, k - stride - padding


def transposed_halo(k: int, stride: int, padding: int
                    ) -> Tuple[int, int, int]:
    """(rows from above, rows from below, first output row in the tile's
    unpadded output) of a transposed convolution's slice."""
    top = -math.ceil((padding - k + 1) / stride)
    bottom = (padding - 1) // stride + 1
    return top, bottom, top * stride + padding


def _neighbour_rows(x: torch.Tensor, top: int, bottom: int,
                    mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The last ``top`` rows (dim 1) of the rank above and the first
    ``bottom`` of the rank below, zeros past the frame: one all-gather of
    every rank's edge rows over its ``'space'`` line."""
    h = x.shape[1]
    if max(top, bottom) > h:
        raise ValueError(f"a halo of {top} and {bottom} rows from slices "
                         f"of {h}")
    n, s = mesh.size(SPACE_AXIS), mesh.index(SPACE_AXIS)
    # Each rank sends its first `bottom` rows (the halo of the rank above
    # it) and its last `top` (of the rank below).
    edge = torch.cat([x[:, :bottom], x[:, h - top:]], dim=1)
    parts = mesh.all_gather(edge, 1, SPACE_AXIS).chunk(n, dim=1)
    zeros = lambda r: x.new_zeros((x.shape[0], r, *x.shape[2:]))
    above = parts[s - 1][:, bottom:] if s > 0 else zeros(top)
    below = parts[s + 1][:, :bottom] if s < n - 1 else zeros(bottom)
    return above, below


def edge_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """NHWC ``x``, this rank's rows of a map -> its (B, 2, W, C) halo
    operand for kernels K1/K2: row 0 the row above x's first, row 1 the
    row below its last, zeros past the frame."""
    return torch.cat(_neighbour_rows(x, 1, 1, mesh), dim=1).contiguous()


class _Halo(torch.autograd.Function):
    """(N, h, ...) -> (N, top + h + bottom, ...): ``top`` rows of the
    rank above and ``bottom`` of the rank below along dim 1 (zeros past
    the frame); the backward adds each halo row's gradient into its
    owner's row."""

    @staticmethod
    def forward(ctx, x, top, bottom, mesh):
        ctx.top, ctx.bottom, ctx.mesh = top, bottom, mesh
        above, below = _neighbour_rows(x, top, bottom, mesh)
        return torch.cat([above, x, below], dim=1)

    @staticmethod
    def backward(ctx, g):
        top, bottom, mesh = ctx.top, ctx.bottom, ctx.mesh
        n, s = mesh.size(SPACE_AXIS), mesh.index(SPACE_AXIS)
        h = g.shape[1] - top - bottom
        # The gradients of this rank's halo rows go back to their owners:
        # its top rows to the rank above, its bottom rows to the one
        # below.
        edge = torch.cat([g[:, :top], g[:, top + h:]], dim=1).contiguous()
        parts = mesh.all_gather(edge, 1, SPACE_AXIS).chunk(n, dim=1)
        dx = g[:, top:top + h].clone()
        if s < n - 1 and top:
            dx[:, h - top:] += parts[s + 1][:, :top]
        if s > 0 and bottom:
            dx[:, :bottom] += parts[s - 1][:, top:]
        return dx, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int,
              mesh: Mesh) -> torch.Tensor:
    """NHWC ``x``, this rank's rows of a map, with ``top`` rows from the
    rank above and ``bottom`` from the rank below (zeros past the frame;
    a negative count crops that many rows of ``x``)."""
    if top < 0:
        x, top = x[:, -top:], 0
    if bottom < 0:
        x, bottom = x[:, :x.shape[1] + bottom], 0
    if top == 0 and bottom == 0:
        return x
    return _Halo.apply(x, top, bottom, mesh)


class _SpaceConv3x3Fn(torch.autograd.Function):
    """K1 on this rank's rows with their halo operand; backward dx = K1 of
    the cotangent, its own halo exchanged, with flipped weights (the halo
    rows' share summed in the kernel, rounded once), dw = K2 of this
    rank's rows and their halo (summed over the ranks with the other
    gradients)."""

    @staticmethod
    def forward(ctx, x, w2d, mesh):
        halo = edge_rows(x, mesh)
        ctx.save_for_backward(x, halo, w2d)
        # Autograd runs the backward on its own thread, outside the mesh.
        ctx.mesh = mesh
        return conv3x3_fwd(x, w2d, halo=halo)

    @staticmethod
    def backward(ctx, g):
        x, halo, w2d = ctx.saved_tensors
        g = g.contiguous()
        cin, cout = x.shape[3], w2d.shape[1]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_fwd(g, flip_transpose(w2d, cin, cout),
                             halo=edge_rows(g, ctx.mesh)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad(x, g, halo=halo).to(w2d.dtype)
        return dx, dw, None


def space_conv3x3(x: torch.Tensor, w2d: torch.Tensor,
                  mesh: Mesh) -> torch.Tensor:
    """The 3x3 SAME conv (K1/K2) of this rank's rows ``x`` (NHWC,
    contiguous) of a height-sharded map with ``w2d`` (9*Cin, Cout): this
    rank's rows of the whole map's conv, no bias."""
    return _SpaceConv3x3Fn.apply(x, w2d, mesh)
