"""FlowNetC training at the reference's FlyingChairs crop size.

    python -m ode_rl_torch.train_flownetc_highres [--steps 300] [--batch 8]
        [--height 320] [--width 448] [--lr 1e-4]
        [--report results/torch/flownetc_highres.json] [--device cuda]

Counterpart of ``scripts/train_flownetc_highres.py``, with its flags and
defaults: the reference trains at 320x448 crops, where FlowNetC's cost
volume runs on 40x56 feature maps. Each batch is one Moving MNIST frame
of three digits upsampled bilinearly to height x width and repeated to 3
channels, (B, 5, 7, 2) normal noise times 8 upsampled bicubically as the
flow, and the frame warped backwards by it (``resample2d``). One step,
then ``--steps`` more of the unfused train step (flow/train.py:
multiscale L1, Adam); the metrics every 50 steps, and every step's EPE,
go into the report with the first and last step's and the step time.
The run fails unless the last step's EPE is below the first's, as the
script's does.

The report has the script's keys plus ``epe`` (every step's),
``device``, and ``step_ms`` closed by a synchronize. ``--device``
defaults to ``cuda``, and a host without CUDA raises rather than fall
back to the CPU. TF32 is off, as in ``ode_rl_torch.main``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from ode_rl_torch.core.device import resolve_device
from ode_rl_torch.data.mmnist import generate_moving_mnist
from ode_rl_torch.data.sprites import get_sprite_bank
from ode_rl_torch.flow.flownets import FlowNetC
from ode_rl_torch.flow.train import make_flow_train_step
from ode_rl_torch.ops.resize import resize_bicubic, resize_bilinear
from ode_rl_torch.ops.warp import resample2d


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--width", type=int, default=448)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--report", default="results/torch/flownetc_highres.json")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def highres_batch_from(frame: torch.Tensor, coarse: torch.Tensor,
                       height: int, width: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(img1, img2, flow) from a (B, 64, 64, 1) frame in [0, 1] and
    (B, h, w, 2) coarse flow noise: the frame repeated to 3 channels and
    resized bilinearly, the noise resized bicubically, img2 the backward
    warp of img1 by the flow."""
    b = frame.shape[0]
    img1 = resize_bilinear(frame.expand(b, -1, -1, 3), height, width)
    flow = resize_bicubic(coarse, height, width)
    return img1, resample2d(img1, flow), flow


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    h, w, b = args.height, args.width, args.batch
    bank = torch.from_numpy(get_sprite_bank()).float().to(device)
    generator = torch.Generator(device=device).manual_seed(0)

    def batch_fn():
        video = generate_moving_mnist(generator, bank, batch=b, n_frames=1,
                                      num_digits=3) + 0.5
        coarse = torch.randn((b, 5, 7, 2), generator=generator,
                             device=device) * 8.0
        return highres_batch_from(video[:, 0], coarse, h, w)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    model = FlowNetC(generator=torch.Generator().manual_seed(1)).to(device)
    init_fn, step_fn = make_flow_train_step(model, lr=args.lr)
    state = init_fn()
    i1, i2, fl = batch_fn()
    t_first = time.time()
    m = step_fn(state, (i1, i2), fl)
    first = {k: float(v) for k, v in m.items()}
    t_first = time.time() - t_first
    print(f"first step: {t_first:.1f}s  loss={first['loss']:.4f} "
          f"epe={first['epe']:.4f}")

    sync()
    t0 = time.time()
    hist, epes = [], [first["epe"]]
    for i in range(args.steps):
        i1, i2, fl = batch_fn()
        m = step_fn(state, (i1, i2), fl)
        epes.append(float(m["epe"]))
        if (i + 1) % 50 == 0:
            cur = {k: float(v) for k, v in m.items()}
            hist.append({"step": i + 1, **cur})
            print(f"[{i + 1}] loss={cur['loss']:.4f} epe={cur['epe']:.4f}")
    sync()
    last = {k: float(v) for k, v in m.items()}
    dt = (time.time() - t0) / max(args.steps, 1) * 1e3

    report = {
        "resolution": f"{h}x{w}", "batch": b, "steps": args.steps,
        "first_loss": first["loss"], "first_epe": first["epe"],
        "final_loss": last["loss"], "final_epe": last["epe"],
        "step_ms": round(dt, 2), "history": hist, "epe": epes,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "note": "the reference's FlyingChairs crop size, PyTorch port",
    }
    path = pathlib.Path(args.report)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=2) + "\n")
    print(f"report → {path}")
    if not last["epe"] < first["epe"]:
        raise AssertionError(f"EPE did not improve: {first['epe']:.4f} -> "
                             f"{last['epe']:.4f}")
    return report


if __name__ == "__main__":
    main()
