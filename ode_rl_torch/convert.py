"""flax variable trees -> ``state_dict`` of the port's modules.

The port names its parameters and buffers by the flax path. Only conv
kernels, the rank-4 ``kernel`` leaves, change layout, by the layer that
holds them:

* ``Conv`` kernels (HWIO, or (kh, kw, Cin/K, Cout) for a conv of K
  groups) become torch's OIHW ``weight``;
* the 3x3 convs of the ODE fields (``ConvNet`` layers ``in``, ``mid_i``,
  ``out``) keep flax's HWIO ``kernel``, because its reshape to
  (9*Cin, Cout) is the layout kernels K1/K2 take;
* ``ConvTranspose`` kernels (the decoder's ``up_i``, FlowNet's ``deconv``
  and ``upflow``, ConvGRUModel's ``dec_0`` and ``dec_1``, S3VAE's
  ``deconv_in``) are flipped spatially and laid out (in, out, kh, kw) for
  ``conv_transpose2d``: flax's transposed conv is torch's with the kernel
  flipped ('SAME' at stride 2 is padding 1, 'VALID' at stride 1 padding
  0);
* every other leaf copies by name: Dense kernels (din, dout), which the
  port keeps in flax's layout (a GRU's Dense may be named ``in``), biases,
  the GroupNorm, LayerNorm and BatchNorm scales and biases, the RIMs'
  (K, din, dout) weights and slot attention's ``slots_mu`` and
  ``slots_log_sigma``.

Given the port's ``module`` as well, a kernel's layout follows the type
of the submodule that holds it, not its name: ``Conv`` and ``Conv3d``
kernels ((kh, kw, I, O), (kd, kh, kw, I, O)) become (O, I, ...);
``ConvTranspose``, ``ConvTransposeStride1`` and ``ConvTransposeValid``
kernels are flipped spatially and laid out (I, O, kh, kw); ``Conv3x3``
keeps HWIO; a leaf of any other submodule takes the name rules above.
Under an ``nn.ModuleList`` whose flax path has no index (JAX's
``nn.vmap`` over S2VAE's slots, ``slot_rollout``), each leaf is a stack
along its first axis and its slices go to the list's members in order:
a rank-5 leaf there is a stack of 2-D conv kernels. The LSTM cells'
Dense kernels (nn/dense.py) copy by name.

A ``batch_stats`` tree (BatchNorm's running ``mean`` and ``var``) fills
the BatchNorm buffers of the same path. The same names carry Vid-ODE
(its encoder's and decoder's convs and BatchNorms, the z0 encoder, the
field, ``encoder_pos`` and ``slot_attention``), the GAN's two
discriminators (``disc_params`` {'image', 'seq'} into an ``nn.ModuleDict``
of those names) and LPIPS (``alex.conv{i}`` and the 1-D ``lin{i}``).
The world models need the module: Dreamer's encoder ``h{i}`` are
``Conv`` and its decoder's ``h{i}`` ``ConvTransposeValid`` under the
same names; the spatial RSSM's cell convs ``update``, ``reset`` and
``out`` are ``Conv``; the CATER classifier's tree is {'wm', 'clf'}, as
its module's. The evaluation models convert by the same rules, either
way: ``MMNISTJudge``'s convs ``c0``-``c2`` and ``ImpalaCNN``'s
``block{i}_conv`` and residual ``c0``/``c1`` are ``Conv`` (the judge's
``fc_m`` and Impala's ``fc`` read their maps flattened NHWC, as flax's,
so their kernels copy unpermuted), ``SpriteJudge``'s ``z_lstm.cell`` is
an LSTM cell and its heads Dense. The leaves may be numpy arrays or
torch tensors (on any device, ``meta`` included); nothing of JAX is
imported.

``torch_to_flax`` is the inverse for the layouts the FlowNets use: a
``state_dict`` back to the flax tree, ``Conv`` weights OIHW -> HWIO,
``ConvTranspose`` weights (I, O, kh, kw) flipped back to (kh, kw, I, O),
every other leaf by name (by the module's submodule types where it is
given, else by the name rules above). Per-slot stacks are not restacked.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn


def _is_field_conv(layer: str) -> bool:
    return layer in ("in", "out") or layer.startswith("mid_")


def _is_transposed_conv(layer: str) -> bool:
    return (layer in ("deconv", "upflow", "dec_0", "dec_1", "deconv_in")
            or layer.startswith("up_"))


Leaf = Union[np.ndarray, torch.Tensor]


def _flip(x: Leaf) -> Leaf:
    """x flipped along its two spatial (leading) axes."""
    if isinstance(x, torch.Tensor):
        return x.flip((0, 1))
    return np.flip(x, (0, 1))


def _permute(x: Leaf, *axes: int) -> Leaf:
    return x.permute(*axes) if isinstance(x, torch.Tensor) else x.transpose(
        *axes)


def _moveaxis(x: Leaf, src: tuple, dst: tuple) -> Leaf:
    return (torch.movedim(x, src, dst) if isinstance(x, torch.Tensor)
            else np.moveaxis(x, src, dst))


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Leaf]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        elif isinstance(value, torch.Tensor):
            yield path + (key,), value
        else:
            yield path + (key,), np.asarray(value)


def _convert(path: Tuple[str, ...], leaf: Leaf
             ) -> Tuple[Tuple[str, ...], Leaf]:
    if path[-1] != "kernel" or leaf.ndim != 4:
        return path, leaf
    if _is_transposed_conv(path[-2]):
        return path[:-1] + ("weight",), _permute(_flip(leaf), 2, 3, 0, 1)
    if _is_field_conv(path[-2]):
        return path, leaf
    return path[:-1] + ("weight",), _permute(leaf, 3, 2, 0, 1)


def _layouts() -> Dict[type, str]:
    from ode_rl_torch.nn.c3d import Conv3d
    from ode_rl_torch.nn.conv_stacks import Conv, Conv3x3, ConvTranspose
    from ode_rl_torch.nn.s3vae_nets import ConvTransposeStride1
    from ode_rl_torch.wm.networks import ConvTransposeValid

    return {Conv: "out_in", Conv3d: "out_in", Conv3x3: "keep",
            ConvTranspose: "flip", ConvTransposeStride1: "flip",
            ConvTransposeValid: "flip"}


def _unstack(path: Tuple[str, ...], leaf: np.ndarray, module: nn.Module
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray, nn.Module]]:
    """(path, leaf, the submodule holding it), a stacked leaf split among
    the members of the ``nn.ModuleList`` it is stacked over."""
    mod = module
    for i, key in enumerate(path[:-1]):
        if isinstance(mod, nn.ModuleList) and not key.isdigit():
            for s in range(len(mod)):
                yield from _unstack(path[:i] + (str(s),) + path[i:],
                                    leaf[s], module)
            return
        mod = mod.get_submodule(key)
    yield path, leaf, mod


def _convert_typed(path: Tuple[str, ...], leaf: Leaf,
                   holder: Optional[nn.Module], layouts: Dict[type, str]
                   ) -> Tuple[Tuple[str, ...], Leaf]:
    """The leaf's layout by its holder's type, else by its name."""
    layout = layouts.get(type(holder))
    if path[-1] != "kernel" or layout is None:
        return _convert(path, leaf)
    if layout == "keep":
        return path, leaf
    weight = path[:-1] + ("weight",)
    if layout == "flip":
        return weight, _permute(_flip(leaf), 2, 3, 0, 1)
    return weight, _moveaxis(leaf, (-1, -2), (0, 1))


def _as_tensor(value: Leaf) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().contiguous().clone()
    return torch.from_numpy(np.array(value))


def flax_to_torch(params: Mapping, batch_stats: Optional[Mapping] = None,
                  module: Optional[nn.Module] = None
                  ) -> Dict[str, torch.Tensor]:
    """A flax 'params' tree of numpy arrays (and its 'batch_stats') -> a
    ``state_dict``; by the port's ``module``'s submodule types where it
    is given, else by the names."""
    layouts = _layouts() if module is not None else {}

    def pieces(tree):
        for path, leaf in _leaves(tree):
            if module is None:
                yield path, leaf, None
            else:
                yield from _unstack(path, leaf, module)

    state = {}
    for path, leaf, holder in pieces(params):
        new_path, value = _convert_typed(path, leaf, holder, layouts)
        state[".".join(new_path)] = _as_tensor(value)
    for path, leaf, _ in pieces(batch_stats or {}):
        state[".".join(path)] = _as_tensor(leaf)
    return state


def flax_last_axis(name: str, value: Leaf,
                   module: Optional[nn.Module] = None) -> int:
    """The dimension of the port's parameter ``name`` that holds the last
    axis of the flax leaf it converts from (a kernel's output channels):
    0 for a ``Conv``'s (and a 3-D conv's) (O, I, ...) ``weight``, 1 for a
    transposed conv's (I, O, kh, kw), the last for a ``Conv3x3``'s HWIO
    ``kernel`` and every leaf copied by name. By the holder's type where
    ``module`` is given, else by the name rules."""
    path = tuple(name.split("."))
    if path[-1] != "weight" or value.ndim < 4:
        return value.ndim - 1
    layout = None
    if module is not None:
        layout = _layouts().get(type(module.get_submodule(
            ".".join(path[:-1]))))
    if layout is None:
        layout = "flip" if _is_transposed_conv(path[-2]) else "out_in"
    return 1 if layout == "flip" else 0


def _unconvert(path: Tuple[str, ...], weight: torch.Tensor,
               layout: Optional[str]) -> Tuple[Tuple[str, ...], torch.Tensor]:
    """A conv ``weight`` back to its flax ``kernel``: by the holder's
    layout where it is known, else by the name rules."""
    kernel = path[:-1] + ("kernel",)
    if layout is None:
        if weight.ndim != 4:
            return path, weight
        layout = "flip" if _is_transposed_conv(path[-2]) else "out_in"
    if layout == "flip":
        return kernel, _flip(_permute(weight, 2, 3, 0, 1))
    return kernel, _moveaxis(weight, (0, 1), (-1, -2))


def torch_to_flax(state: Mapping[str, torch.Tensor],
                  module: Optional[nn.Module] = None) -> Dict:
    """A ``state_dict`` of the port's parameters -> the flax 'params' tree
    of the same values, as contiguous tensors on the state's device (the
    inverse of ``flax_to_torch``)."""
    layouts = _layouts() if module is not None else {}
    tree: Dict = {}
    for name, value in state.items():
        path = tuple(name.split("."))
        if path[-1] == "weight":
            layout = None
            if module is not None:
                holder = module.get_submodule(".".join(path[:-1]))
                layout = layouts.get(type(holder))
                if layout == "keep":
                    raise ValueError(f"{name}: a Conv3x3 keeps its flax "
                                     "'kernel' name")
            path, value = _unconvert(path, value, layout)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value.detach().contiguous()
    return tree
