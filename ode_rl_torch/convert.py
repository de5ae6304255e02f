"""flax parameter tree -> ``state_dict`` of the port's modules.

The port names its parameters by the flax path, with one rule per kind
of leaf:

* ``Conv`` kernels (HWIO) become torch's OIHW ``weight``;
* the 3x3 convs of the ODE fields (``ConvNet`` layers ``in``, ``mid_i``,
  ``out``) keep flax's HWIO ``kernel``, because its reshape to
  (9*Cin, Cout) is the layout kernels K1/K2 take;
* ``ConvTranspose`` kernels (the decoder's ``up_i``, FlowNet's ``deconv``
  and ``upflow``, ConvGRUModel's ``dec_0`` and ``dec_1``) are flipped
  spatially and laid out (in, out, kh, kw) for
  ``conv_transpose2d(stride=2, padding=1)``: flax's 'SAME' transposed conv
  is torch's with the kernel flipped;
* biases and the GroupNorm scales and biases copy by name.

The input holds numpy arrays only; nothing of JAX is imported.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def _is_field_conv(layer: str) -> bool:
    return layer in ("in", "out") or layer.startswith("mid_")


def _is_transposed_conv(layer: str) -> bool:
    return (layer in ("deconv", "upflow", "dec_0", "dec_1")
            or layer.startswith("up_"))


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), np.asarray(value)


def _convert(path: Tuple[str, ...], leaf: np.ndarray
             ) -> Tuple[Tuple[str, ...], np.ndarray]:
    if path[-1] != "kernel":
        return path, leaf
    if _is_transposed_conv(path[-2]):
        return path[:-1] + ("weight",), np.flip(leaf, (0, 1)).transpose(
            2, 3, 0, 1)
    if _is_field_conv(path[-2]):
        return path, leaf
    return path[:-1] + ("weight",), leaf.transpose(3, 2, 0, 1)


def flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax 'params' tree of numpy arrays -> a ``state_dict``."""
    state = {}
    for path, leaf in _leaves(params):
        new_path, value = _convert(path, leaf)
        state[".".join(new_path)] = torch.from_numpy(np.array(value))
    return state
