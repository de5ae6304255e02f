"""Write a synthetic stand-in for one of the Vid-ODE corpora.

    python -m ode_rl_torch.make_synthetic_corpus --dataset kth \\
        [--out datasets/kth] [--train_videos 40] [--test_videos 8] [--seed 0]

Counterpart of ``scripts/make_synthetic_corpus.py``, with its flags, its
draws and its layout, which ``data/video_corpus.py::VideoCorpus`` (and
JAX's loader) read: ``<out>/{train,test}/video_<i:05d>.npy``, uint8 (T,
H, W, C) at the dataset's raw geometry (``RAW_SPECS``), each video's
length drawn in the dataset's range, moving Gaussian blobs
(``write_synthetic_corpus``). The same flags write the script's bytes;
each file's sha256 is printed, so two hosts can be checked to write the
same corpus. numpy only, on the host.
"""

from __future__ import annotations

import argparse
import pathlib
from typing import Dict, Optional, Sequence

from ode_rl_torch.data.video_corpus import (RAW_SPECS, corpus_sha256,
                                            write_synthetic_corpus)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", required=True, choices=sorted(RAW_SPECS))
    ap.add_argument("--out", default=None,
                    help="the corpus's directory (default datasets/<dataset>)")
    ap.add_argument("--train_videos", type=int, default=40)
    ap.add_argument("--test_videos", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Writes the corpus; returns {'<split>/video_<i>.npy': sha256}."""
    args = parse_args(argv)
    out = pathlib.Path(args.out or f"datasets/{args.dataset}")
    write_synthetic_corpus(out, args.dataset, args.train_videos,
                           args.test_videos, args.seed)
    digests = corpus_sha256(out)
    for name, digest in digests.items():
        print(f"{name} sha256 {digest}")
    print(f"{args.dataset}: {args.train_videos} train and {args.test_videos} "
          f"test videos -> {out}")
    return digests


if __name__ == "__main__":
    main()
