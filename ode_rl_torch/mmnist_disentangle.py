"""S3VAE disentanglement on Moving MNIST: latent swaps judged by a
classifier, and latent probes.

    python -m ode_rl_torch.mmnist_disentangle --ckpt_full s3vae_r4_full \\
        --ckpt_abl s3vae_r4_ablation [--judge_steps 1500] \\
        [--eval_batches 16] [--logdir logs] \\
        [--out results/torch/s3vae_disentangle.json] [--device cuda] \\
        [--probe_train_batches 64] [--probe_eval_batches 16] \\
        [--probe_steps 600]

Counterpart of ``scripts/mmnist_disentangle.py``, with its flags, its
defaults and the keys of its JSON report:

1. ``train_judge``: the judge (eval_models/mmnist_judge.py) trained with
   Adam (1e-3) on labelled one-digit Moving MNIST from the first
   ``N_SPRITES`` sprites (``generate_moving_mnist_labeled``; sprite =
   content, start/end quadrant = motion);
2. ``restore_s3vae``: each S3VAE run (the four-term model and the
   l1 = l2 = l3 = 0 ablation) from the config and checkpoint that
   ``python -m ode_rl_torch.main`` saved under ``--logdir``;
3. ``eval_swaps``: the model's ``predict(..., swap=True)`` in training
   mode, which decodes the observed window, judged on (z_f of A, z_t of
   the donor) and (z_f of the donor, z_t of A), the donor the previous
   video of the batch;
4. ``latent_probes``: two-layer MLP probes (Adam 3e-3, full batch)
   reading the sprite and the quadrants off mu_zf and off the time-pooled
   [mean, std] of mu_zt.

JAX decodes in training mode with BatchNorm's statistics mutable and
throws their updates away; here ``frozen_buffers`` puts every buffer
back after each decode, so the probes leave the model as they found it.
The draws come from generators seeded from JAX's keys' seeds (the judge's
data 0 and weights 1, the swaps' 42, the probes' 7; the data of the
swaps and the probes from the next seed), so the numbers are the port's
own, not JAX's. ``--logdir``, ``--device`` and the three probe flags are
the port's: JAX's script reads ``logs`` and fixes the probes' sizes at
these defaults.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.core.device import resolve_device
from ode_rl_torch.data.mmnist import generate_moving_mnist_labeled
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.data.sprites import get_sprite_bank
from ode_rl_torch.eval_models.mmnist_judge import MMNISTJudge, quadrant_labels
from ode_rl_torch.nn.dense import Dense
from ode_rl_torch.train.step import restore_model

N_SPRITES = 16


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_full", default="s3vae_r4_full")
    ap.add_argument("--ckpt_abl", default="s3vae_r4_ablation")
    ap.add_argument("--judge_steps", type=int, default=1500)
    ap.add_argument("--eval_batches", type=int, default=16)
    ap.add_argument("--out", default="results/torch/s3vae_disentangle.json")
    ap.add_argument("--logdir", default="logs")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--probe_train_batches", type=int, default=64)
    ap.add_argument("--probe_eval_batches", type=int, default=16)
    ap.add_argument("--probe_steps", type=int, default=600)
    return ap.parse_args(argv)


@contextlib.contextmanager
def frozen_buffers(model: nn.Module) -> Iterator[None]:
    """Every buffer of ``model`` (BatchNorm's running statistics) put back
    as it was when the block ends."""
    saved = {name: b.detach().clone() for name, b in model.named_buffers()}
    try:
        yield
    finally:
        with torch.no_grad():
            for name, b in model.named_buffers():
                b.copy_(saved[name])


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _labelled(gen: torch.Generator, bank: torch.Tensor, batch: int,
              n_frames: int):
    """(video in [-0.5, 0.5], sprite (B,), q0, q1) of one-digit clips."""
    video, idx, pos = generate_moving_mnist_labeled(gen, bank, batch=batch,
                                                    n_frames=n_frames,
                                                    num_digits=1)
    q0, q1 = quadrant_labels(pos)
    return video, idx[:, 0], q0, q1


def train_judge(bank: torch.Tensor, steps: int, batch: int = 64,
                n_frames: int = 20):
    """The judge trained ``steps`` Adam steps on fresh labelled batches;
    returns (judge, the last step's metrics)."""
    judge = MMNISTJudge(n_sprites=N_SPRITES,
                        generator=torch.Generator().manual_seed(1)).to(
        bank.device)
    opt = torch.optim.Adam(judge.parameters(), lr=1e-3, betas=(0.9, 0.999),
                           eps=1e-8)
    gen = _generator(bank.device, 0)
    m = {}
    for i in range(steps):
        video, s, q0, q1 = _labelled(gen, bank, batch, n_frames)
        opt.zero_grad(set_to_none=True)
        loss, m = judge.loss(video + 0.5, s, q0, q1)
        loss.backward()
        opt.step()
        m = {k: v.detach() for k, v in m.items()}
        if i % 250 == 0 or i == steps - 1:
            mm = {k: round(float(x), 4) for k, x in m.items()}
            print(f"judge step {i}: {mm}", flush=True)
    return judge, {k: float(x) for k, x in m.items()}


@torch.no_grad()
def judge_accs(judge: MMNISTJudge, video: torch.Tensor, sprite, q0,
               q1) -> Dict[str, float]:
    """Each head's accuracy on ``video`` (frames in [0, 1], clipped)
    against the given labels."""
    logits = judge(torch.clamp(video, 0.0, 1.0))
    acc = lambda lg, y: float(np.mean(
        lg.argmax(-1).cpu().numpy() == np.asarray(y)))
    return {"sprite": acc(logits["sprite"], sprite),
            "q0": acc(logits["q0"], q0), "q1": acc(logits["q1"], q1)}


def restore_s3vae(ckpt_id: str, logdir, device: torch.device):
    """(model, config) of an S3VAE run of ``ode_rl_torch.main``."""
    model, cfg, _ = restore_model(logdir, "S3VAE", ckpt_id, device)
    return model, cfg


def _observed_decode(model, video: torch.Tensor, n_in: int,
                     generator: torch.Generator, swap: bool = False):
    """``predict`` in training mode (the observed window), the BatchNorm
    statistics left as they were."""
    bd = make_batch_dict(video, n_in=n_in, with_flow_labels=True)
    with torch.no_grad(), frozen_buffers(model):
        return model.predict(bd, generator, train=True, swap=swap)


def eval_swaps(model, cfg, judge: MMNISTJudge, bank: torch.Tensor,
               n_batches: int, batch: int = 32) -> Dict:
    """The judge's accuracies on real videos, reconstructions and the two
    swaps, averaged over ``n_batches``, and the four headline numbers."""
    t = int(cfg.train_in_seq) + int(cfg.train_out_seq)
    n_in = int(cfg.train_in_seq)
    sample_gen = _generator(bank.device, 42)
    data_gen = _generator(bank.device, 43)
    tallies = {k: [] for k in (
        "real", "recon",
        "swapm_content_own", "swapm_motion_donor", "swapm_motion_own",
        "swapc_content_donor", "swapc_content_own", "swapc_motion_own")}
    for _ in range(n_batches):
        video, idx, pos = generate_moving_mnist_labeled(
            data_gen, bank, batch=batch, n_frames=t, num_digits=1)
        x_hat, aux = _observed_decode(model, video, n_in, sample_gen,
                                      swap=True)
        sprite = idx[:, 0].cpu().numpy()
        # In training mode the model decodes the observed window, so every
        # judged tensor and both motion labels are over frames [0, n_in).
        q0, q1 = (q.cpu().numpy() for q in quadrant_labels(pos[:, :, :n_in]))
        donor = lambda a: np.roll(a, 1, axis=0)   # the model rolls by 1
        accs = lambda x, s, a, b: judge_accs(judge, x, s, a, b)
        tallies["real"].append(accs(video[:, :n_in] + 0.5, sprite, q0, q1))
        tallies["recon"].append(accs(x_hat[:, :n_in], sprite, q0, q1))
        xm = aux["x_swap_motion"][:, :n_in]    # own z_f, donor z_t
        xc = aux["x_swap_content"][:, :n_in]   # donor z_f, own z_t
        tallies["swapm_content_own"].append(
            accs(xm, sprite, q0, q1)["sprite"])
        tallies["swapm_motion_donor"].append(
            accs(xm, sprite, donor(q0), donor(q1)))
        tallies["swapm_motion_own"].append(accs(xm, sprite, q0, q1))
        tallies["swapc_content_donor"].append(
            accs(xc, donor(sprite), q0, q1)["sprite"])
        tallies["swapc_content_own"].append(
            accs(xc, sprite, q0, q1)["sprite"])
        tallies["swapc_motion_own"].append(accs(xc, sprite, q0, q1))

    def agg(rows):
        if isinstance(rows[0], dict):
            return {k: round(float(np.mean([r[k] for r in rows])), 4)
                    for k in rows[0]}
        return round(float(np.mean(rows)), 4)

    out = {k: agg(v) for k, v in tallies.items()}
    out["content_preserved_under_motion_swap"] = out["swapm_content_own"]
    out["motion_transferred_under_motion_swap"] = (
        (out["swapm_motion_donor"]["q0"]
         + out["swapm_motion_donor"]["q1"]) / 2.0)
    out["content_transferred_under_content_swap"] = out[
        "swapc_content_donor"]
    out["motion_preserved_under_content_swap"] = (
        (out["swapc_motion_own"]["q0"] + out["swapc_motion_own"]["q1"])
        / 2.0)
    return out


class _Probe(nn.Module):
    def __init__(self, din: int, n_classes: int, generator: torch.Generator):
        super().__init__()
        self.h = Dense(din, 128, generator=generator)
        self.out = Dense(128, n_classes, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(torch.relu(self.h(x)))


def fit_probe(x_tr: np.ndarray, y_tr: np.ndarray, x_te: np.ndarray,
              y_te: np.ndarray, n_classes: int, probe_steps: int,
              device: torch.device) -> float:
    """Held-out accuracy of a two-layer MLP probe trained full-batch with
    Adam (3e-3) on standardised features."""
    m, s = x_tr.mean(0), x_tr.std(0) + 1e-6
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    x_tr_n, x_te_n = as_t((x_tr - m) / s), as_t((x_te - m) / s)
    y = torch.from_numpy(np.asarray(y_tr)).long().to(device)
    probe = _Probe(x_tr.shape[1], n_classes,
                   torch.Generator().manual_seed(0)).to(device)
    opt = torch.optim.Adam(probe.parameters(), lr=3e-3, betas=(0.9, 0.999),
                           eps=1e-8)
    for _ in range(probe_steps):
        opt.zero_grad(set_to_none=True)
        F.cross_entropy(probe(x_tr_n), y).backward()
        opt.step()
    with torch.no_grad():
        pred = probe(x_te_n).argmax(-1).cpu().numpy()
    return float((pred == np.asarray(y_te)).mean())


def latent_probes(model, cfg, bank: torch.Tensor, n_train_batches: int = 64,
                  n_eval_batches: int = 16, batch: int = 64,
                  probe_steps: int = 600) -> Dict[str, float]:
    """How well each factor reads off each latent: the sprite and the
    quadrants from mu_zf (B, d_zf) and from [mean, std] over T of mu_zt,
    probes trained on ``n_train_batches`` and scored on the next
    ``n_eval_batches``, with the chance levels and the two margins."""
    t = int(cfg.train_in_seq) + int(cfg.train_out_seq)
    n_in = int(cfg.train_in_seq)
    sample_gen = _generator(bank.device, 7)
    data_gen = _generator(bank.device, 8)
    feats = {"zf": [], "zt": []}
    labels = {"sprite": [], "q0": [], "q1": []}
    for _ in range(n_train_batches + n_eval_batches):
        video, idx, pos = generate_moving_mnist_labeled(
            data_gen, bank, batch=batch, n_frames=t, num_digits=1)
        _, aux = _observed_decode(model, video, n_in, sample_gen)
        zt = aux["mu_zt"].float()
        zt = zt.reshape(*zt.shape[:2], -1)
        feats["zf"].append(aux["mu_zf"].float().reshape(batch, -1)
                           .cpu().numpy())
        feats["zt"].append(torch.cat([zt.mean(dim=1),
                                      zt.std(dim=1, correction=0)],
                                     dim=-1).cpu().numpy())
        q0, q1 = quadrant_labels(pos[:, :, :n_in])
        labels["sprite"].append(idx[:, 0].cpu().numpy())
        labels["q0"].append(q0.cpu().numpy())
        labels["q1"].append(q1.cpu().numpy())
    cut = n_train_batches
    cat = lambda rows: np.concatenate(rows, axis=0)
    tr = {k: cat(v[:cut]) for k, v in feats.items()}
    te = {k: cat(v[cut:]) for k, v in feats.items()}
    ltr = {k: cat(v[:cut]) for k, v in labels.items()}
    lte = {k: cat(v[cut:]) for k, v in labels.items()}
    fit = lambda lat, lab, n: fit_probe(tr[lat], ltr[lab], te[lat], lte[lab],
                                        n, probe_steps, bank.device)

    out = {}
    for lat in ("zf", "zt"):
        out[f"identity_from_{lat}"] = round(fit(lat, "sprite", N_SPRITES), 4)
        out[f"motion_from_{lat}"] = round(
            (fit(lat, "q0", 4) + fit(lat, "q1", 4)) / 2.0, 4)
    out["chance_identity"] = round(1.0 / N_SPRITES, 4)
    out["chance_motion"] = 0.25
    # How much more each factor reads off its own latent than off the
    # other (>= 0: factorised, about 0: entangled).
    out["content_axis_margin"] = round(
        out["identity_from_zf"] - out["identity_from_zt"], 4)
    out["motion_axis_margin"] = round(
        out["motion_from_zt"] - out["motion_from_zf"], 4)
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    bank = torch.from_numpy(get_sprite_bank()[:N_SPRITES]).float().to(device)
    judge, judge_final = train_judge(bank, args.judge_steps)

    report = {"judge_train_final": judge_final,
              "n_sprites": N_SPRITES, "models": {}}
    for tag, ckpt_id in (("full_4term", args.ckpt_full),
                         ("ablation_l123_0", args.ckpt_abl)):
        print(f"== evaluating {tag} ({ckpt_id})", flush=True)
        model, cfg = restore_s3vae(ckpt_id, args.logdir, device)
        row = eval_swaps(model, cfg, judge, bank,
                         n_batches=args.eval_batches)
        row["latent_probes"] = latent_probes(
            model, cfg, bank, n_train_batches=args.probe_train_batches,
            n_eval_batches=args.probe_eval_batches,
            probe_steps=args.probe_steps)
        row["ckpt_id"] = ckpt_id
        row["loss_weights"] = {"l1": float(cfg.get("l1")),
                               "l2": float(cfg.get("l2")),
                               "l3": float(cfg.get("l3"))}
        report["models"][tag] = row
        print(json.dumps(row, indent=2), flush=True)

    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(f"report -> {out}")
    return report


if __name__ == "__main__":
    main()
