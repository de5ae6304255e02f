"""Evaluate a trained checkpoint on fixed held-out videos of a frozen
corpus, the port's side of the matched-step parity table.

    python -m ode_rl_torch.parity_eval --data datasets/parity \\
        --ckpt_id parity_odecgru_port --out logs/parity/port \\
        [--model ODEConv] [--logdir logs] [--n_in 10] [--eval_outs 10,90] \\
        [--eval_videos 32] [--batch 4] [--device cuda]

Counterpart of ``scripts/jax_parity_eval.py``, with its flags and
defaults (``--eval_videos`` 32; PARITY.md's runs use 64): the test
split's videos 0..N-1 of the corpus at ``--data``, each windowed at
frame 0, ``--n_in`` observed frames and each of ``--eval_outs``
predicted, through the port's eval step (train/step.py, the model's
draws from a generator seeded 0 at every batch, as JAX passes key 0) and
the per-horizon MSE, PSNR and SSIM of train/metrics.py, averaged over
the batches, into ``<out>/metrics.json`` with JAX's keys: ``ckpt_id``,
``step`` and ``"<n_in>to<n_out>"`` -> {"mse", "psnr", "ssim"}, each a
list over the horizon. The model is built from the config saved beside
the checkpoint (``python -m ode_rl_torch.main`` writes both). The test
phase of ``main`` samples random windows, so it cannot stand in for this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ode_rl_torch.core.device import resolve_device
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.train.step import make_eval_step, restore_model


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default="datasets/parity")
    ap.add_argument("--ckpt_id", default="parity_odecgru_port")
    ap.add_argument("--logdir", default="logs")
    ap.add_argument("--model", default="ODEConv")
    ap.add_argument("--n_in", type=int, default=10)
    ap.add_argument("--eval_outs", default="10,90")
    ap.add_argument("--eval_videos", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", default="logs/parity/port")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def held_out_videos(data: pathlib.Path, n: int) -> np.ndarray:
    """The first ``n`` videos of the corpus's test split, (n, T, H, W)
    uint8."""
    shards = sorted((data / "test").glob("shard_*.npy"))
    if not shards:
        raise FileNotFoundError(f"no test shards under {data / 'test'}")
    videos = np.concatenate([np.load(s) for s in shards])[:n]
    if len(videos) < n:
        raise ValueError(f"{data}: {len(videos)} test videos, "
                         f"{n} asked for")
    return videos


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    model, _, step = restore_model(args.logdir, args.model, args.ckpt_id,
                                   device)
    print(f"loaded {args.ckpt_id} step {step}")
    eval_step = make_eval_step()
    videos = held_out_videos(pathlib.Path(args.data), args.eval_videos)

    results = {"ckpt_id": args.ckpt_id, "step": step}
    for n_out in [int(x) for x in args.eval_outs.split(",")]:
        n_tot = args.n_in + n_out
        per = []
        for b0 in range(0, args.eval_videos, args.batch):
            clip = videos[b0:b0 + args.batch, :n_tot]
            video = clip.astype(np.float32)[..., None] / 255.0 - 0.5
            batch = make_batch_dict(torch.from_numpy(video).to(device),
                                    n_in=args.n_in)
            metrics, _ = eval_step(model, batch, torch.Generator(
                device=device).manual_seed(0))
            per.append({k: v.cpu().numpy() for k, v in metrics.items()
                        if not k.startswith("aux_")})
        stacked = {k: np.mean(np.stack([m[k] for m in per]), axis=0)
                   for k in per[0]}
        results[f"{args.n_in}to{n_out}"] = {k: v.tolist()
                                            for k, v in stacked.items()}
        print(f"{args.n_in}to{n_out}: final-horizon "
              f"mse={stacked['mse'][-1]:.5f} psnr={stacked['psnr'][-1]:.2f} "
              f"ssim={stacked['ssim'][-1]:.4f}")

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "metrics.json").write_text(json.dumps(results, indent=2))
    print("wrote", out / "metrics.json")
    return results


if __name__ == "__main__":
    main()
