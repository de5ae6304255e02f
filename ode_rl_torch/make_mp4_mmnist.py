"""Write a Moving MNIST corpus as ``video_<n>.mp4`` files, the reference's
frozen-mode layout.

    python -m ode_rl_torch.make_mp4_mmnist --out /tmp/mp4_mmnist \\
        [--videos 40] [--test_videos 8] [--frames 60] [--fps 10] \\
        [--seed 0] [--device cuda]

Counterpart of ``scripts/make_mp4_mmnist.py``, with its flags, defaults
and layout: ``<out>/train/video_<n>.mp4`` (``--videos`` of them, seed
``--seed``) and ``<out>/test/video_<n>.mp4`` (``--test_videos``, seed
``--seed`` + 1), ``--frames`` gray frames of 64x64 each, written as BGR
with cv2's ``mp4v`` fourcc at ``--fps``, from batches of 8 videos of 3
digits. ``data/frozen.py`` (and JAX's loader) read it:

    python -m ode_rl_torch.main --configs defaults \\
        train_mmnist_odecgru_len20_1ch --frozen True --data_dir <out>

The frames come from the port's ``data/mmnist.py::generate_moving_mnist``
with a ``torch.Generator`` seeded from ``--seed`` on ``--device`` (the
card unless ``--device cpu``), not from ``jax.random``, and mp4v is
lossy: the same flags write other bits than the script does, and a
corpus is checked by decoding it, not by its digests. cv2 is imported
only to write.
"""

from __future__ import annotations

import argparse
import pathlib
from typing import Optional, Sequence

import torch

from ode_rl_torch.core.device import resolve_device
from ode_rl_torch.data.mmnist import generate_moving_mnist
from ode_rl_torch.data.sprites import get_sprite_bank

# Videos generated a batch, and digits a video (the script's).
BATCH, DIGITS = 8, 3


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--videos", type=int, default=40)
    ap.add_argument("--test_videos", type=int, default=8)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def write_split(out_dir: pathlib.Path, n_videos: int, frames: int, fps: int,
                seed: int, device: torch.device) -> None:
    import cv2

    out_dir.mkdir(parents=True, exist_ok=True)
    bank = torch.from_numpy(get_sprite_bank()).float().to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    done = 0
    while done < n_videos:
        b = min(BATCH, n_videos - done)
        video = generate_moving_mnist(gen, bank, batch=BATCH,
                                      n_frames=frames, num_digits=DIGITS)
        vids = ((video[..., 0] + 0.5) * 255.0).clamp(0, 255).to(
            torch.uint8).cpu().numpy()
        for i in range(b):
            path = out_dir / f"video_{done + i}.mp4"
            w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                                fps, (vids.shape[3], vids.shape[2]))
            if not w.isOpened():
                raise IOError(f"VideoWriter failed for {path}")
            for t in range(frames):
                w.write(cv2.cvtColor(vids[i, t], cv2.COLOR_GRAY2BGR))
            w.release()
        done += b
    print(f"wrote {n_videos} mp4 videos ({frames} frames) -> {out_dir}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    out = pathlib.Path(args.out)
    write_split(out / "train", args.videos, args.frames, args.fps, args.seed,
                device)
    write_split(out / "test", args.test_videos, args.frames, args.fps,
                args.seed + 1, device)


if __name__ == "__main__":
    main()
