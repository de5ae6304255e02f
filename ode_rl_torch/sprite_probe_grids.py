"""Filmstrips of the DS-VAE's probe forwards from a trained checkpoint.

    python -m ode_rl_torch.sprite_probe_grids [--ckpt_id train_sprite_dsvae]
        [--logdir logs] [--out results/torch/dsvae_probes] [--batch 4]
        [--device cuda]

Counterpart of ``scripts/sprite_probe_grids.py``: restores the DS-VAE a
``train_sprite_dsvae`` run of ``python -m ode_rl_torch.main`` wrote,
makes ``--batch`` Sprites clips (generator seeded 0; the probes take
frames in [0, 1]) and writes one filmstrip a probe forward,
``<out>/<probe>.png``: the first two inputs over the probe's first two
outputs (train/visualize.py). The probes are JAX's four (swapped content,
frozen motion, frozen content, free generation from the prior) and the
two generators of the disagreement protocol (their generations), each
with its draws from a generator seeded 2, in eval mode.
"""

from __future__ import annotations

import argparse
import pathlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from ode_rl_torch.core.device import resolve_device
from ode_rl_torch.core.noise import Noise
from ode_rl_torch.sprite.data import sprites_batch
from ode_rl_torch.train.step import restore_model
from ode_rl_torch.train.visualize import save_filmstrip

PROBES = ("forward_exchange", "forward_fixed_motion",
          "forward_fixed_content", "forward_generating",
          "forward_fixed_action_for_classification",
          "forward_fixed_content_for_classification")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_id", default="train_sprite_dsvae")
    ap.add_argument("--logdir", default="logs")
    ap.add_argument("--out", default="results/torch/dsvae_probes")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[pathlib.Path]:
    """Writes the filmstrips; returns their paths."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    model, cfg, step = restore_model(args.logdir, "DSVAE", args.ckpt_id,
                                     device)
    model.eval()
    print(f"loaded {args.ckpt_id} step {step}")
    video, _action, _color = sprites_batch(
        Noise(torch.Generator(device=device).manual_seed(0)), args.batch,
        int(cfg.train_in_seq), device)
    x = video + 0.5
    out = pathlib.Path(args.out)
    written = []
    for probe in PROBES:
        with torch.no_grad():
            y = getattr(model, probe)(x, torch.Generator(
                device=device).manual_seed(2))
        if isinstance(y, tuple):
            y = y[0]    # the generation, not the posterior-mean recon
        host = lambda v: v.float().cpu().numpy()
        strips = [host(x[i]) for i in range(min(2, args.batch))]
        strips += [host(y[i]) for i in range(min(2, y.shape[0]))]
        written.append(save_filmstrip(out / f"{probe}.png",
                                      [np.asarray(s) for s in strips]))
        print(f"wrote {written[-1]}")
    return written


if __name__ == "__main__":
    main()
