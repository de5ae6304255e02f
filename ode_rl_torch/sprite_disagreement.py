"""DS-VAE disagreement scores on the Sprites clips.

    python -m ode_rl_torch.sprite_disagreement [--logdir logs] \\
        [--ckpt_id train_sprite_dsvae] [--steps 400] [--batches 8] \\
        [--batch_size 64] [--out results/torch/sprite_disagreement.json] \\
        [--device cuda]

Counterpart of ``scripts/sprite_disagreement.py``, with its flags (its
``--cpu`` is the port's ``--device cpu``; the TPU default it sets is not
the port's), its judge and its JSON keys: restore the DS-VAE that
``python -m ode_rl_torch.main`` trained on ``train_sprite_dsvae``, train
the ``SpriteJudge`` (Adam 1e-3) on the posterior means (z, f) of fresh
labelled clips, then for each sweep generate videos with one factor
pinned and the other resampled (the DS-VAE's
``forward_fixed_action_for_classification``: content from N(0, I);
``forward_fixed_content_for_classification``: motion from the free
prior), re-encode the generations and score the judge's action
probabilities on the originals against those on the generations
(sprite/disagreement.py). A disentangled model keeps the action
agreement high under content resampling and low under motion
resampling.

As JAX's script does, the clips go to the encoder as ``sprites_batch``
makes them, in [-0.5, 0.5], although the model trained on [0, 1] frames
(ROADMAP queue 3 lists this fault, kept so that both give the same
protocol). The model runs in eval mode. All draws (clips, posterior
samples, generations) come from one generator seeded 0; the judge's
weights from a CPU generator seeded 1.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ode_rl_torch.core.device import resolve_device
from ode_rl_torch.core.noise import Noise
from ode_rl_torch.sprite.classifier import SpriteJudge
from ode_rl_torch.sprite.data import sprites_batch
from ode_rl_torch.sprite.disagreement import disagreement_scores
from ode_rl_torch.train.step import restore_model


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--logdir", default="logs")
    ap.add_argument("--ckpt_id", default="train_sprite_dsvae")
    ap.add_argument("--steps", type=int, default=400,
                    help="judge training steps")
    ap.add_argument("--batches", type=int, default=8,
                    help="eval batches for the disagreement sweep")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out",
                    default="results/torch/sprite_disagreement.json")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    model, cfg, step = restore_model(args.logdir, "DSVAE", args.ckpt_id,
                                     device)
    model.eval()
    n_frames = int(cfg.get("train_in_seq", 8))
    print(f"restored DS-VAE {args.ckpt_id} (step {step})")
    noise = Noise(torch.Generator(device=device).manual_seed(0))

    @torch.no_grad()
    def encode(x):
        f_mean, _, _, z_mean, _, _ = model.encode_and_sample_post(
            x, False, noise)
        return z_mean, f_mean

    sweeps = {"fixed_action_resampled_content":
              model.forward_fixed_action_for_classification,
              "fixed_content_resampled_motion":
              model.forward_fixed_content_for_classification}

    # The judge, trained on posterior latents of real clips.
    judge = SpriteJudge(model.z_dim, model.f_dim, hidden=128,
                        generator=torch.Generator().manual_seed(1)).to(device)
    opt = torch.optim.Adam(judge.parameters(), lr=1e-3, betas=(0.9, 0.999),
                           eps=1e-8)
    for i in range(args.steps):
        x, a, c = sprites_batch(noise, args.batch_size, n_frames, device)
        z, f = encode(x)
        opt.zero_grad(set_to_none=True)
        loss, m = judge.loss(z, f, a, c)
        loss.backward()
        opt.step()
        if i % 100 == 0 or i == args.steps - 1:
            print(f"judge step {i}: "
                  f"action_acc={float(m['action_acc']):.3f} "
                  f"attr_acc={float(m['attr_acc']):.3f}")

    @torch.no_grad()
    def action_probs(z, f) -> np.ndarray:
        return torch.softmax(judge(z, f)[0].float(), -1).cpu().numpy()

    results = {}
    for name, generate in sweeps.items():
        p1s, p2s, gts = [], [], []
        for _ in range(args.batches):
            x, a, _c = sprites_batch(noise, args.batch_size, n_frames,
                                     device)
            p1s.append(action_probs(*encode(x)))
            with torch.no_grad():
                x_gen = generate(x, noise)[0]
            p2s.append(action_probs(*encode(x_gen)))
            gts.append(a.cpu().numpy())
        results[name] = disagreement_scores(
            np.concatenate(p1s), np.concatenate(p2s), np.concatenate(gts))
        print(name, json.dumps(results[name]))

    report = {"ckpt_step": int(step), "judge_steps": args.steps, **results}
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print("wrote", out)
    return report


if __name__ == "__main__":
    main()
