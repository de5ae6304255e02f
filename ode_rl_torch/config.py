"""The flagship configuration as a frozen dataclass.

The JAX package reads ``configs.yaml``; the port does not, so that it
needs no YAML parser. ``FlagshipConfig`` holds the merged blocks
``defaults`` + ``tpu_bench_odecgru`` for every key the flagship training
step reads, under the YAML's own names (a CPU test holds each field to the
YAML). Derive a variant with ``dataclasses.replace``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FlagshipConfig:
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
