"""The port's configurations as frozen dataclasses.

The JAX package reads ``configs.yaml``; the port does not, so that it
needs no YAML parser. ``FlagshipConfig`` holds the merged blocks
``defaults`` + ``tpu_bench_odecgru`` for every key the flagship training
step reads, under the YAML's own names (a CPU test holds each field to the
YAML). The two FlowNet configurations keep the names of their sources,
``bench.py`` and ``scripts/train_flownetc.py`` (CPU tests hold them to the
JAX package's defaults). Derive a variant with ``dataclasses.replace``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FlagshipConfig:
    model: str = "ODEConv"
    batch_size: int = 128
    train_in_seq: int = 10
    train_out_seq: int = 10
    resolution: int = 64
    in_channels: int = 1
    num_digits: int = 3
    data_dir: str = "datasets/MovingMNIST_video"
    n_downs: int = 2
    conv_encoder_out_ch: int = 64
    neural_ode_decoder_out_ch: int = 64
    neural_ode_n_units: int = 64
    n_ode_layers: int = 3
    compute_dtype: str = "bfloat16"
    decode_diff_method: str = "dopri5"
    odeint_rtol: float = 1e-4
    odeint_atol: float = 1e-5
    ode_max_steps: int = 128
    ode_solver: str = "fast"
    lr: float = 1e-4
    clip: float = -1
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class FlowNetCBenchConfig:
    """``bench.py::bench_flownetc``: FlowNetC in bf16 on the fused
    synthetic-chairs step, multiscale L1."""
    batch: int = 256
    dtype: str = "bfloat16"
    max_displacement: int = 20
    corr_stride: int = 2
    lr: float = 1e-4
    loss_norm: str = "l1"
    single_scale: bool = False
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class FlowNet2Config:
    """``scripts/train_flownetc.py --net 2``: the stacked FlowNet2 in fp32,
    single-scale L1 on the fusion output."""
    batch: int = 8
    lr: float = 1e-4
    dtype: str = "float32"
    rgb_max: float = 1.0
    loss_norm: str = "l1"
    single_scale: bool = True
    seed: int = 0
