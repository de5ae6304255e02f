"""Command-line entry point of the port.

    python -m ode_rl_torch.main --configs defaults \\
        train_mmnist_odecgru_len20_1ch [--key value ...] [--device cpu]

Counterpart of the repo's ``main.py``: the named blocks of ``configs.yaml``
merge left to right and every resulting key is a typed ``--key value``
flag. ``--device`` is the port's own argument, not a config key; it
defaults to ``cuda``, and a host without CUDA raises rather than fall
back to the CPU.

fp32 convs and matmuls run in full fp32: ``main`` turns TF32 off for
cuDNN and for matmul before it builds anything (torch lets cuDNN's fp32
convs run in TF32 by default; JAX's fp32 convs do not), and says so.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence, Tuple

import torch

from ode_rl_torch.core.config import Config, add_cli_overrides, load_config
from ode_rl_torch.core.device import resolve_device


def get_cfg(argv: Sequence[str]) -> Tuple[Config, torch.device]:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--configs", nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args, remaining = parser.parse_known_args(argv)
    merged = load_config(args.configs).to_dict()
    return Config(add_cli_overrides(merged, remaining)), torch.device(
        args.device)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    cfg, device = get_cfg(sys.argv[1:] if argv is None else argv)
    device = resolve_device(device)
    print("TF32 off: fp32 convs (cuDNN) and matmuls run in fp32")
    from ode_rl_torch.train.loop import test, train

    if cfg.phase == "train":
        return train(cfg, device)
    if cfg.phase == "test":
        return test(cfg, device)
    raise ValueError(f"unknown phase {cfg.phase!r}")


if __name__ == "__main__":
    main()
