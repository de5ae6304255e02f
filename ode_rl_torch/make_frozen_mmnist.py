"""Write a frozen Moving MNIST corpus with the native generator.

    python -m ode_rl_torch.make_frozen_mmnist --out datasets/MovingMNIST_frozen \\
        [--videos 10000] [--frames 200] [--digits 3] [--shard_size 500] \\
        [--seed 0] [--train_split 0.8]

Counterpart of ``scripts/make_frozen_mmnist.py``, with its flags and its
layout, which ``data/frozen.py`` (and JAX's loader) read:
``<out>/{train,test}/shard_<i:04d>.npy`` of (n, frames, 64, 64) uint8,
shard ``i`` generated from seed ``seed + i``, no shard across the
train/test boundary, and ``<out>/meta.json``. Each shard's sha256 is
printed as it is written, so the same command on two hosts can be checked
to write the same bytes. The generator is ``native/mmnist_gen.cc``
compiled on this host (data/native_gen.py), with no numpy fallback; the
corpus is made on the host and needs no card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import time
from typing import Dict, Optional, Sequence

import numpy as np

from ode_rl_torch.data.native_gen import native_generator
from ode_rl_torch.data.sprites import get_sprite_bank


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="datasets/MovingMNIST_frozen")
    ap.add_argument("--videos", type=int, default=10000)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--digits", type=int, default=3)
    ap.add_argument("--shard_size", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train_split", type=float, default=0.8)
    return ap.parse_args(argv)


def sha256(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Writes the corpus; returns {'<split>/shard_<i>.npy': sha256}."""
    args = parse_args(argv)
    gen = native_generator()
    print(f"native generator {gen.path.name} (built in "
          f"{gen.build_seconds:.2f} s)", flush=True)
    out = pathlib.Path(args.out)
    (out / "train").mkdir(parents=True, exist_ok=True)
    (out / "test").mkdir(parents=True, exist_ok=True)
    bank = get_sprite_bank()
    n_train = int(args.videos * args.train_split)

    t0 = time.time()
    written, shard_id, digests = 0, 0, {}
    while written < args.videos:
        # Shards never straddle the train/test boundary.
        limit = n_train if written < n_train else args.videos
        n = min(args.shard_size, limit - written)
        frames = gen.generate(bank, seed=args.seed + shard_id, batch=n,
                              n_frames=args.frames, num_digits=args.digits)
        split = "train" if written < n_train else "test"
        name = f"{split}/shard_{shard_id:04d}.npy"
        np.save(out / name, frames)
        digests[name] = sha256(out / name)
        written += n
        shard_id += 1
        rate = written * args.frames / (time.time() - t0)
        print(f"{written}/{args.videos} videos ({rate:.0f} frames/s on the "
              f"host); {name} sha256 {digests[name]}", flush=True)

    (out / "meta.json").write_text(json.dumps({
        "videos": args.videos, "frames": args.frames,
        "digits": args.digits, "seed": args.seed,
        "train_videos": n_train, "shard_size": args.shard_size,
    }))
    print("done:", out)
    return digests


if __name__ == "__main__":
    main()
