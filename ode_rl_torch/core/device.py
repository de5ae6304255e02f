"""The device of a command-line entry point.

The port's commands take ``--device`` (default ``cuda``): a host without
CUDA raises rather than fall back to the CPU. fp32 convs and matmuls run
in full fp32 (TF32 off for cuDNN and matmul), as ``ode_rl_torch.main``
runs them.
"""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """``name`` (a string or a ``torch.device``) as a device, TF32 off."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host; pass "
                           "--device cpu to run on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device
