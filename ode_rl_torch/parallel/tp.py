"""Tensor parallelism over the ``'model'`` axis: column-parallel layers.

Counterpart of ``ode_rl_tpu/parallel/tp.py``. JAX's rule
(``tp_param_spec``) shards the output channels of every conv or dense
kernel whose flax leaf has at least two axes and a last axis (its output
channels) of at least ``min_channels`` divisible by the ``'model'`` size;
everything else is replicated, and GSPMD inserts the collectives. The
port applies the same rule to the flax leaf each parameter converts from
(convert.py: torch's OIHW ``weight`` holds flax's last axis in
dimension 0, a transposed conv's (in, out, kh, kw) in 1, a ``Conv3x3``'s
HWIO ``kernel`` and a Dense kernel in their last), and writes the
collectives of a column-parallel layer:

* its input is replicated over the ``'model'`` line; ``_CopyIn`` passes
  it on, and its backward sums the line's partial input gradients (each
  rank's from its slice of output channels) in fp32, then rounds once to
  the input's dtype;
* each rank computes its slice of output channels; ``_GatherChannels``
  all-gathers them along the last (NHWC channel) axis, and its backward
  keeps this rank's channels of the cotangent, which every rank of the
  line holds whole and equal (the layers after it are replicated): it
  does not sum them, as ``mesh._AllGather``'s backward does for rows;
* the bias is replicated and added after the gather, so its gradient is
  whole on every rank.

For ``Conv3x3`` (kernels K1/K2) one Function does all three:
``_ColumnConv3x3Fn`` runs K1 on the rank's Cout slice, gathers, and in
its backward takes K2 on the slice's cotangent and dx as K1 on the
slice's cotangent and flipped weights with an fp32 output (in a bf16
step the tensor-core K1 writes its fp32 sums of exact bf16 products
unrounded), all-reduced over ``'model'`` in fp32 and then rounded, so the
dx of a bf16 step is rounded once, as the one-process step rounds it.

``Mesh.all_reduce_grads`` averages a sharded leaf's gradient over its
``'data'`` line only, and the train step's ``grad_norm`` sums a sharded
leaf's squares over ``'model'`` (train/step.py).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from ode_rl_torch.parallel.mesh import (MODEL_AXIS, Mesh, axis_mesh,
                                        shard_pytree)

__all__ = ["tp_param_spec", "shard_params_tp", "column_parallel",
           "column_conv3x3", "is_sharded", "model_mesh"]


def tp_param_spec(module: nn.Module, mesh, min_channels: int = 64
                  ) -> Dict[str, tuple]:
    """Parameter name -> ``PartitionSpec``-like tuple: ``'model'`` at the
    dimension that holds the flax leaf's last axis where JAX's rule
    shards it, else all None. ``mesh`` needs only ``shape['model']``."""
    from ode_rl_torch.convert import flax_last_axis
    n_model = mesh.shape[MODEL_AXIS]
    specs = {}
    for name, p in module.named_parameters():
        spec = [None] * p.ndim
        if p.ndim >= 2:
            dim = flax_last_axis(name, p, module)
            out_ch = p.shape[dim]
            if out_ch >= min_channels and out_ch % n_model == 0:
                spec[dim] = MODEL_AXIS
        specs[name] = tuple(spec)
    return specs


def _tp_layers() -> tuple:
    from ode_rl_torch.nn.conv_stacks import Conv, Conv3x3, ConvTranspose
    return Conv, Conv3x3, ConvTranspose


def shard_params_tp(module: nn.Module, mesh: Mesh,
                    min_channels: int = 64) -> nn.Module:
    """Keep this rank's output-channel slice of every parameter
    ``tp_param_spec`` shards (``shard_pytree``). Raises where a sharded
    parameter belongs to a layer without a column-parallel forward."""
    specs = tp_param_spec(module, mesh, min_channels)
    layers = _tp_layers()
    for name, spec in specs.items():
        if MODEL_AXIS in spec:
            holder = module.get_submodule(name.rpartition(".")[0])
            if not isinstance(holder, layers):
                raise NotImplementedError(
                    f"{name}: a {type(holder).__name__} has no "
                    "column-parallel forward (Conv, Conv3x3 and "
                    "ConvTranspose have)")
    return shard_pytree(module, mesh, specs)


def is_sharded(layer: nn.Module, leaf: str = "weight") -> bool:
    """Whether ``layer``'s parameter ``leaf`` holds a ``'model'`` slice
    (``shard_pytree`` notes it on the layer)."""
    return leaf in getattr(layer, "tp_dims", {})


def model_mesh(what: str) -> Mesh:
    """The entered mesh of a ``'model'`` line, for a sharded layer."""
    mesh = axis_mesh(MODEL_AXIS)
    if mesh is None:
        raise RuntimeError(f"{what} holds a 'model' slice of its weights: "
                           "call it inside its ('data', 'model') mesh")
    return mesh


def _sum_partials(g: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The line's partial gradients summed in fp32, rounded once."""
    total = g.float().contiguous().clone()
    return mesh.all_reduce_(total, MODEL_AXIS).to(g.dtype)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_partials(g, ctx.mesh), None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh, ctx.n = mesh, y.shape[-1]
        return mesh.all_gather(y, y.ndim - 1, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(MODEL_AXIS)
        return g.narrow(g.ndim - 1, i * ctx.n, ctx.n).contiguous(), None


def column_parallel(x: torch.Tensor, local: Callable, mesh: Mesh
                    ) -> torch.Tensor:
    """``local`` (this rank's output channels of a layer) on ``x``
    replicated over the ``'model'`` line, the channels gathered."""
    return _GatherChannels.apply(local(_CopyIn.apply(x, mesh)), mesh)


class _ColumnConv3x3Fn(torch.autograd.Function):
    """K1 on this rank's Cout slice, gathered; the backward as the module
    docstring says."""

    @staticmethod
    def forward(ctx, x, w2d, mesh):
        from ode_rl_torch.ops.conv3x3 import conv3x3_fwd
        ctx.save_for_backward(x, w2d)
        ctx.mesh = mesh
        return mesh.all_gather(conv3x3_fwd(x, w2d), 3, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        from ode_rl_torch.ops.conv3x3 import (conv3x3_fwd, conv3x3_wgrad,
                                              flip_transpose)
        x, w2d = ctx.saved_tensors
        mesh = ctx.mesh
        cin, cout = x.shape[3], w2d.shape[1]
        i = mesh.index(MODEL_AXIS)
        g = g.narrow(3, i * cout, cout).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            part = conv3x3_fwd(g, flip_transpose(w2d, cin, cout),
                               out_dtype=torch.float32)
            dx = mesh.all_reduce_(part, MODEL_AXIS).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad(x, g).to(w2d.dtype)
        return dx, dw, None


def column_conv3x3(x: torch.Tensor, w2d: torch.Tensor,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """K1 with this rank's (9*Cin, Cout/n) weights, all Cout gathered."""
    mesh = mesh or model_mesh("a Conv3x3")
    return _ColumnConv3x3Fn.apply(x, w2d, mesh)
