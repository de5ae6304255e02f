"""Dispatch rule and launch bookkeeping for the hand-written kernels.

Counterpart of ``ode_rl_tpu/ops/common.py``. The rule is set by where the
tensor lies, and nothing else:

* a CPU tensor takes the kernel's plain PyTorch version;
* a CUDA tensor takes the kernel, or the call raises (wrong architecture,
  dtype, shape or layout). There is no environment opt-out and no
  fallback from a failed build or launch.

``force_plain()`` is the one exception: tests and ``chip_smoke.py``'s
comparison phase use it to run the plain versions on the card.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch

# dtype codes of ode_rl_torch/csrc/common.cuh::DType.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches per kernel wrapper. A wrapper adds one where it launches its
# kernel and nowhere else, so a run can show that the main path went
# through every kernel.
launches = {"conv3x3_fwd": 0, "conv3x3_wgrad": 0, "gru_gates": 0,
            "gru_blend": 0, "correlation_fwd": 0, "correlation_bwd_f1": 0,
            "correlation_bwd_f2": 0, "channelnorm": 0}

# Process-wide on purpose: autograd runs CUDA backward passes on its own
# threads, which must see the same choice as the forward.
_plain_forced = False


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def force_plain() -> Iterator[None]:
    """Run the plain versions even on CUDA tensors, inside this block."""
    global _plain_forced
    previous = _plain_forced
    _plain_forced = True
    try:
        yield
    finally:
        _plain_forced = previous


def use_kernel(x: torch.Tensor) -> bool:
    """True where ``x`` lies on a CUDA device (the kernel runs), False on
    the CPU (the plain version runs)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel or plain version for device {x.device}")
    return not _plain_forced


def check_inputs(name: str, tensors: dict, dtype: torch.dtype) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``
    on one sm_90 device."""
    device = next(iter(tensors.values())).device
    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) != (9, 0):
        raise RuntimeError(
            f"{name}: the kernels are built for sm_90a (H100); "
            f"{torch.cuda.get_device_name(device)} is sm_{major}{minor}")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} is not float32 or bfloat16")
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.numel() == 0:
            raise ValueError(f"{name}: {arg} is empty")


def launch(name: str, fn: Callable[..., int], *args) -> None:
    """Call a C entry point of the kernel library, which launches on the
    current stream and returns ``cudaGetLastError()``; raise if it is not
    0, else count the launch."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    launches[name] += 1


def stream_handle(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
