"""Write a corpus of synthetic PHYRE rollouts.

    python -m ode_rl_torch.generate_phyre_dataset [--out datasets/phyre] \\
        [--train_videos 40] [--test_videos 8] [--frames 40] [--seed 0] \\
        [--synthetic]

Counterpart of ``scripts/generate_phyre_dataset.py``'s synthetic branch,
with the script's flags and layout: ``<out>/{train,test}/rollout_<i:05d>.npy``
of ``--frames`` frames, uint8 (T, 64, 64, 3), balls under gravity in
PHYRE's palette on white (``data/video_corpus.py::phyre_rollout``), the
bytes the script writes with ``--synthetic`` (or without the ``phyre``
package) at the same flags. The script's other branch simulates real
PHYRE tasks through the ``phyre`` package, which the port does not use:
this command writes synthetic rollouts only, and takes ``--synthetic``
for the script's command line. Each file's sha256 is printed. numpy
only, on the host.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from ode_rl_torch.data.video_corpus import corpus_sha256, write_phyre_corpus


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Write synthetic PHYRE rollouts (balls under gravity, "
        "64x64 RGB), the bytes of scripts/generate_phyre_dataset.py "
        "--synthetic. Real PHYRE simulations are not written: they need "
        "the phyre package.")
    ap.add_argument("--out", default="datasets/phyre")
    ap.add_argument("--train_videos", type=int, default=40)
    ap.add_argument("--test_videos", type=int, default=8)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--synthetic", action="store_true",
                    help="the script's flag; this command always writes "
                    "synthetic rollouts")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Writes the corpus; returns {'<split>/rollout_<i>.npy': sha256}."""
    args = parse_args(argv)
    write_phyre_corpus(args.out, args.train_videos, args.test_videos,
                       args.frames, args.seed)
    digests = corpus_sha256(args.out)
    for name, digest in digests.items():
        print(f"{name} sha256 {digest}")
    print(f"phyre: {args.train_videos} train and {args.test_videos} test "
          f"synthetic rollouts of {args.frames} frames -> {args.out}")
    return digests


if __name__ == "__main__":
    main()
