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
import functools
from typing import Callable, Iterator

import torch

# dtype codes of ode_rl_torch/csrc/common.cuh::DType.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches per kernel wrapper. A wrapper adds one where it launches its
# kernel and nowhere else, so a run can show that the main path went
# through every kernel. "conv3x3_fwd" counts every K1 launch,
# "conv3x3_fwd_tc" those of its tensor-core kernel, "conv3x3_fwd_simt"
# those of its SIMT kernel and "conv3x3_fwd_halo" those (of either) with a
# halo operand (a 'space' rank's rows); likewise K2. "conv3x3_fwd_nt32"
# and "conv3x3_fwd_nt16" count the tensor-core K1's launches in column
# blocks of 32 and 16 output channels (the rest take 64).
# "gru_gates" counts every K3 launch, "gru_gates_sample" those of its
# one-sample kernel and "gru_gates_2pass" those of its two-pass kernel;
# likewise K4; "gru_gates_mom" and "gru_blend_mom" count the moments-in
# K3 and K4 (a 'space' mesh axis), "gru_gates_mom_vec" and
# "gru_gates_mom_scalar" the moments-in K3's vector and scalar kernels,
# likewise K4's ("gru_blend_mom_vec", "gru_blend_mom_scalar"), and
# "gru_moments" their moments pass, "gru_moments_vec" and
# "gru_moments_scalar" its vector and scalar kernels.
# "correlation_fwd" counts every K5 launch,
# "correlation_fwd_tc" those of its tensor-core kernel and
# "correlation_fwd_pairs" those of its SIMT pair-view kernel (small maps);
# likewise K6 and K7 ("correlation_bwd_f1_pairs",
# "correlation_bwd_f2_pairs").
launches = {"conv3x3_fwd": 0, "conv3x3_fwd_tc": 0, "conv3x3_fwd_simt": 0,
            "conv3x3_fwd_halo": 0, "conv3x3_fwd_nt32": 0,
            "conv3x3_fwd_nt16": 0, "conv3x3_wgrad": 0, "conv3x3_wgrad_tc": 0,
            "conv3x3_wgrad_simt": 0, "conv3x3_wgrad_halo": 0,
            "gru_gates": 0, "gru_gates_sample": 0,
            "gru_gates_2pass": 0, "gru_blend": 0, "gru_blend_sample": 0,
            "gru_blend_2pass": 0, "gru_gates_mom": 0,
            "gru_gates_mom_vec": 0, "gru_gates_mom_scalar": 0,
            "gru_blend_mom": 0, "gru_blend_mom_vec": 0,
            "gru_blend_mom_scalar": 0, "gru_moments": 0,
            "gru_moments_vec": 0, "gru_moments_scalar": 0,
            "correlation_fwd": 0,
            "correlation_fwd_tc": 0, "correlation_fwd_pairs": 0,
            "correlation_bwd_f1": 0, "correlation_bwd_f1_tc": 0,
            "correlation_bwd_f1_pairs": 0, "correlation_bwd_f2": 0,
            "correlation_bwd_f2_tc": 0, "correlation_bwd_f2_pairs": 0,
            "channelnorm": 0}

# Process-wide on purpose: autograd runs CUDA backward passes on its own
# threads, which must see the same choice as the forward.
_plain_forced = False


# The H of the maps of the K1/K2 launches with a halo operand.
halo_heights: set = set()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    halo_heights.clear()


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


@functools.cache
def _capability(device: torch.device) -> tuple[int, int]:
    # Cached: the query costs microseconds of host time on every launch.
    return torch.cuda.get_device_capability(device)


def check_inputs(name: str, tensors: dict, dtype: torch.dtype) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``
    on one sm_90 device."""
    device = next(iter(tensors.values())).device
    major, minor = _capability(device)
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


def bf16_ulps(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """How far a bf16 result lies from an fp64 reference rounded to bf16:
    (largest distance in bf16 ulps, share of outputs that differ).

    The ulp is that of the rounded reference, taken at no less than
    rms(ref) / 256 in magnitude. Where a sum of
    hundreds of products cancels to below that magnitude, a bf16 ulp is
    finer than the fp32 rounding error of the sum itself, so a correct
    kernel can lie many such ulps off; elsewhere one ulp is the bound."""
    ref = ref.double()
    rounded = ref.to(torch.bfloat16).double()
    floor = ref.pow(2).mean().sqrt() / 256
    mag = torch.maximum(rounded.abs(), floor).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    diff = out.double() - rounded
    return ((diff.abs() / ulp).max().item(),
            (diff != 0).double().mean().item())


def stream_handle(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
