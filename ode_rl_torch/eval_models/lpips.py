"""LPIPS, the learned perceptual distance (net-lin, AlexNet).

Counterpart of ``ode_rl_tpu/eval_models/lpips.py``: images (B, H, W, 3)
in [0, 1] go to [-1, 1], then the ImageNet shift and scale; AlexNet's
conv features at its five relu taps (3x3 stride-2 max pools after the
first two), each unit-normalised over its channels (1e-10 added to the
norm); the squared differences weighed by the absolute ``lin`` weights,
summed over channels, averaged over the map, summed over the taps:
(B,) scores.

No weights are fetched. ``load_torch_weights`` reads converted
torchvision AlexNet convs (``conv{i}_w`` OIHW, ``conv{i}_b``) and the
LPIPS ``lin{i}`` weights from ``.npz`` files
(scripts/convert_lpips_weights.py writes them); without them the
features are random (the port's own init, not JAX's) and the scores are
valid only for relative comparison, which ``lpips_distance`` warns of
once. ``lpips_horizon_fn`` is the test phase's per-horizon LPIPS: its
``metric_key`` is ``lpips`` with weights and ``lpips_uncalibrated``
without, so the calibration shows in every artifact's key.
"""

from __future__ import annotations

import pathlib
import warnings
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ode_rl_torch.nn.conv_stacks import Conv

# (features, kernel, stride, padding) of AlexNet's five convs.
ALEX_PLAN = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
             (256, 3, 1, 1), (256, 3, 1, 1)]
_POOL_AFTER = {0, 1}
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _AlexFeatures(nn.Module):
    def __init__(self, generator: torch.Generator):
        super().__init__()
        cin = 3
        for i, (f, k, s, p) in enumerate(ALEX_PLAN):
            self.add_module(f"conv{i}", Conv(cin, f, k, stride=s, padding=p,
                                             generator=generator))
            cin = f

    def forward(self, x: torch.Tensor):
        taps = []
        for i in range(len(ALEX_PLAN)):
            x = F.relu(getattr(self, f"conv{i}")(x))
            taps.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(
                    0, 2, 3, 1)
        return taps


class LPIPS(nn.Module):
    def __init__(self, *, generator: torch.Generator):
        super().__init__()
        self.alex = _AlexFeatures(generator)
        for i, (f, _, _, _) in enumerate(ALEX_PLAN):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(f)))

    def forward(self, img1: torch.Tensor, img2: torch.Tensor
                ) -> torch.Tensor:
        shift = img1.new_tensor(_SHIFT)
        scale = img1.new_tensor(_SCALE)
        norm_in = lambda im: (im * 2.0 - 1.0 - shift) / scale
        total = 0.0
        for i, (a, b) in enumerate(zip(self.alex(norm_in(img1)),
                                       self.alex(norm_in(img2)))):
            unit = lambda v: v / (torch.linalg.vector_norm(
                v, dim=-1, keepdim=True) + 1e-10)
            diff2 = (unit(a) - unit(b)) ** 2
            weighted = torch.sum(diff2 * torch.abs(getattr(self, f"lin{i}")),
                                 dim=-1)
            total = total + weighted.mean(dim=(1, 2))
        return total


_WARNED = [False]


def lpips_distance(model: LPIPS, img1: torch.Tensor, img2: torch.Tensor,
                   calibrated: bool = False) -> torch.Tensor:
    """(B,) scores; warns once when the weights are random."""
    if not calibrated and not _WARNED[0]:
        warnings.warn(
            "LPIPS running with random (uncalibrated) features: valid for "
            "relative comparisons only. Give converted weights "
            "(lpips_alexnet_npz) for published-scale scores.")
        _WARNED[0] = True
    return model(img1, img2)


def load_torch_weights(model: LPIPS, alexnet_npz,
                       lins_npz: Optional[str] = None) -> LPIPS:
    """Load the AlexNet convs (and the ``lin`` weights) from ``.npz``
    files; a named file that is missing raises."""
    data = np.load(alexnet_npz)
    with torch.no_grad():
        for i in range(len(ALEX_PLAN)):
            conv = getattr(model.alex, f"conv{i}")
            conv.weight.copy_(torch.from_numpy(data[f"conv{i}_w"]))
            conv.bias.copy_(torch.from_numpy(data[f"conv{i}_b"]))
        if lins_npz:
            lins = np.load(lins_npz)
            for i in range(len(ALEX_PLAN)):
                getattr(model, f"lin{i}").copy_(
                    torch.from_numpy(lins[f"lin{i}"]).reshape(-1))
    return model


def lpips_horizon_fn(cfg, device: torch.device
                     ) -> Optional[Callable[[torch.Tensor, torch.Tensor],
                                            torch.Tensor]]:
    """The test phase's (pred, gt) (B, T, H, W, C) in [0, 1] -> (T,) mean
    LPIPS, with its ``metric_key``; None where ``eval_lpips`` is off
    (``auto``: on for VidODE). Grayscale frames are repeated to RGB,
    other frames keep their first three channels."""
    mode = cfg.get("eval_lpips", "auto")
    enabled = (cfg.model in ("VidODE",)
               if isinstance(mode, str) and mode.lower() == "auto"
               else bool(mode))
    if not enabled:
        return None
    model = LPIPS(generator=torch.Generator().manual_seed(0))
    calibrated = False
    alex = str(cfg.get("lpips_alexnet_npz", "") or "")
    lins = str(cfg.get("lpips_lins_npz", "") or "")
    if alex:
        if not pathlib.Path(alex).exists():
            raise FileNotFoundError(
                f"lpips_alexnet_npz={alex!r} does not exist: refusing to "
                f"fall back to uncalibrated random features (leave the "
                f"flag empty to opt into uncalibrated LPIPS)")
        load_torch_weights(model, alex, lins or None)
        calibrated = True
        print(f"LPIPS: calibrated weights from {alex}")
    model = model.to(device).eval()

    @torch.no_grad()
    def fn(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        to_rgb = lambda x: (x.expand(*x.shape[:-1], 3) if x.shape[-1] == 1
                            else x[..., :3])
        b, t = pred.shape[:2]
        flat = lambda x: to_rgb(torch.clamp(x.float().movedim(1, 0), 0.0,
                                            1.0)).reshape(t * b,
                                                          *x.shape[2:4], 3)
        scores = lpips_distance(model, flat(pred), flat(gt), calibrated)
        return scores.reshape(t, b).mean(dim=1)

    fn.metric_key = "lpips" if calibrated else "lpips_uncalibrated"
    return fn
