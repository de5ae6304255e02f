"""Write the port's step-0 checkpoint from a JAX init, so that a
matched-step parity run of both packages starts from one set of weights.

    python -m ode_rl_torch.parity_init --params <init.npz> \\
        --configs defaults train_mmnist_cgru_len20 [--key value ...] \\
        [--noise 1e-7] [--device cuda]

``--params`` is the float32 ``.npz`` of a flax 'params' tree, its leaves'
paths joined with ``/`` (``tests/torch_port_parity_init.py`` writes it
beside JAX's own step-0 checkpoint), read with numpy only. The model is
the one ``python -m ode_rl_torch.main`` builds for the same ``--configs``
and flags; the params are converted into it by ``convert.flax_to_torch``
(strictly: every parameter must come from the file), with a fresh
optimizer state. The snapshot goes where that ``main`` looks for it
(``<logdir>/<model>/<run id>/checkpoints``, tag ``ckpt_id``) at step 0,
so ``main`` with the same flags resumes from it at step 0 and reads the
same batches as a fresh run. A directory that already holds checkpoints
is refused.

``--noise s`` multiplies every parameter by ``1 + s * n`` (``perturb``
with seed 0): the run that measures how far rounding-sized differences
alone carry a training run.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ode_rl_torch.convert import flax_to_torch
from ode_rl_torch.core.checkpoint import CheckpointManager
from ode_rl_torch.core.config import resolve_run_id
from ode_rl_torch.core.device import resolve_device
from ode_rl_torch.main import get_cfg
from ode_rl_torch.train.step import create_train_state


def read_params(path) -> Dict:
    """The ``.npz`` at ``path`` as a nested flax 'params' tree."""
    tree: Dict = {}
    with np.load(path) as npz:
        for name in npz.files:
            *parents, leaf = name.split("/")
            node = tree
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = npz[name]
    return tree


def perturb(model: torch.nn.Module, scale: float, seed: int = 0) -> None:
    """Every parameter times 1 + scale * n, n a standard normal tensor a
    parameter in the order of ``model.parameters()``, drawn from a CPU
    generator seeded ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_((1 + scale * torch.randn(p.shape, generator=gen)).to(
                p.device))


def main(argv: Optional[Sequence[str]] = None) -> pathlib.Path:
    """Writes the checkpoint; returns its path."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--params", required=True)
    ap.add_argument("--noise", type=float, default=0.0)
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    cfg, device = get_cfg(rest)
    device = resolve_device(device)
    if cfg.phase != "train":
        raise ValueError(f"parity_init writes a train run's step 0, not "
                         f"phase {cfg.phase!r}")
    run_id = resolve_run_id(cfg)
    ckpt = CheckpointManager(
        pathlib.Path(cfg.get("logdir", "logs")) / cfg.model / run_id
        / "checkpoints", tag=cfg.get("ckpt_id", run_id))
    if ckpt.latest_step() is not None:
        raise FileExistsError(f"{ckpt.directory} already holds checkpoints")
    state = create_train_state(cfg, device)
    state.model.load_state_dict(
        flax_to_torch(read_params(args.params), module=state.model),
        strict=True)
    if args.noise:
        perturb(state.model, args.noise)
    path = ckpt.save(0, {"model": state.model.state_dict(),
                         "optimizer": state.optimizer.state_dict()},
                     config=cfg.to_dict())
    noise = f" x (1 + {args.noise:g} noise)" if args.noise else ""
    print(f"wrote {path}: {args.params}{noise}, fresh optimizer state")
    return path


if __name__ == "__main__":
    main()
