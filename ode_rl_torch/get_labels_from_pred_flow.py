"""Write per-video DFP motion labels from FlowNetC's predicted flow.

    python -m ode_rl_torch.get_labels_from_pred_flow --data datasets/parity
        [--splits train,test] [--flownet_params logs/flow/flownetc.msgpack]
        [--grid 3] [--topk 3] [--batch_videos 8] [--device cuda]

Counterpart of ``scripts/get_labels_from_pred_flow.py``, with its flags
and defaults: for every video of a frozen corpus, FlowNetC's flow between
consecutive frames, split into a grid x grid grid, and a label of 1 on
each cell whose mean flow magnitude is at least the top-k-th
(data/flow_labels.py). Each video's labels are (T, grid^2) float32, row
0 zeros (no transition into the first frame), saved as
``<stem>_labels.npy`` beside each shard. It reads both corpus layouts:
frozen Moving MNIST shards (``{split}/shard_*.npy``, (N, T, H, W) uint8)
and per-video files (``video_*.npy``: (T, H, W) or (T, H, W, C)).
Without weights (``--flownet_params`` empty or missing) the labels come
from a randomly initialised FlowNetC, with JAX's warning. ``--device``
defaults to ``cuda``, and a host without CUDA raises rather than fall
back to the CPU.
"""

from __future__ import annotations

import argparse
import pathlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ode_rl_torch.core.device import resolve_device
from ode_rl_torch.data.flow_labels import make_flownet_label_fn
from ode_rl_torch.flow.flownets import FlowNetC
from ode_rl_torch.flow.train import load_flax_params, load_flownet_params


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--splits", default="train,test")
    ap.add_argument("--flownet_params", default="")
    ap.add_argument("--grid", type=int, default=3)
    ap.add_argument("--topk", type=int, default=3)
    ap.add_argument("--batch_videos", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, tuple]:
    """Writes the label files; returns {label file: its shape}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    net = FlowNetC(generator=torch.Generator().manual_seed(0)).to(device)
    net.requires_grad_(False)
    if args.flownet_params and pathlib.Path(args.flownet_params).exists():
        load_flax_params(net, load_flownet_params(
            args.flownet_params)["params"])
        print("loaded FlowNetC params from", args.flownet_params)
    else:
        print("warning: no trained FlowNetC params given — labels come "
              "from a random-init net (train one with python -m "
              "ode_rl_torch.train_flownetc)")
    label_fn = make_flownet_label_fn(net, grid=args.grid, topk=args.topk)

    written = {}
    root = pathlib.Path(args.data)
    for split in args.splits.split(","):
        files = [f for f in sorted((root / split).glob("*.npy"))
                 if not f.stem.endswith("_labels")]
        for f in files:
            videos = np.load(f, mmap_mode="r")
            if videos.ndim == 3:            # one video (T, H, W)
                videos = videos[None, ..., None]
            elif videos.ndim == 4 and videos.shape[-1] in (1, 3, 6):
                videos = videos[None]       # one video (T, H, W, C)
            labels = []
            for b0 in range(0, videos.shape[0], args.batch_videos):
                clip = np.asarray(videos[b0:b0 + args.batch_videos],
                                  np.float32) / 255.0
                if clip.ndim == 4:
                    clip = clip[..., None]
                lab = label_fn(torch.from_numpy(clip).to(device))
                lab = lab.cpu().numpy()
                zeros = np.zeros((lab.shape[0], 1, lab.shape[2]), lab.dtype)
                labels.append(np.concatenate([zeros, lab], axis=1))
            out = f.with_name(f.stem + "_labels.npy")
            labels = np.concatenate(labels)
            np.save(out, labels)
            written[str(out)] = labels.shape
            print(f"{f.name}: labels {labels.shape} → {out.name}")
    return written


if __name__ == "__main__":
    main()
