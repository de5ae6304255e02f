"""Vid-ODE window samplers: regular or irregular, interpolation or
extrapolation.

Counterpart of ``ode_rl_tpu/data/samplers.py``; every random draw comes
from the caller's ``Noise`` (core/noise.py), in JAX's order:

* regular interpolation: in training every second frame of a random
  window of ``sample_size`` frames, all observed; in test the first
  window, its even frames observed;
* regular extrapolation: a contiguous window (random in training, the
  first in test), all observed;
* irregular interpolation: a window of ``window_size`` frames (random in
  training when the video is longer), its first and last frames and
  ``sample_size - 2`` random interior ones observed;
* irregular extrapolation: as irregular interpolation, with
  ``sample_size / 2 - 1`` random frames in each half of the window.

The random subset of k positions in [lo, hi) is the k largest of a
uniform draw over the window. Frames stay (B, T, H, W, C); the pattern
of observations lives in the (B, T) mask. ``split_batch`` makes the
batch dict of ``split_and_subsample_batch``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ode_rl_torch.core.noise import Noise, as_noise


def _random_subset_mask(noise: Noise, b: int, lo: int, hi: int, k: int,
                        size: int, device: torch.device) -> torch.Tensor:
    """(b, size) bool: exactly k of the positions [lo, hi) set in each
    row, the k largest of a uniform draw."""
    scores = noise.uniform((b, size), device)
    pos = torch.arange(size, device=device)
    in_range = (pos >= lo) & (pos < hi)
    scores = torch.where(in_range, scores,
                         torch.full_like(scores, -float("inf")))
    if k > 0:
        thresh = torch.sort(scores, dim=-1).values[:, -k:-k + 1 or None]
    else:
        thresh = torch.full((b, 1), float("inf"), device=device)
    return (scores >= thresh) & in_range


def _take_windows(video: torch.Tensor, start: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """video (B, T, ...) at frames start[b] + offsets -> (B, len, ...)."""
    idx = start.to(video.device)[:, None] + offsets.to(video.device)[None]
    return video[torch.arange(video.shape[0], device=video.device)[:, None],
                 idx]


def sample_regular_interp(noise: Noise, video: torch.Tensor,
                          sample_size: int, train: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, t = video.shape[:2]
    dev = video.device
    if train:
        start = noise.randint(0, t - sample_size + 1, (b,), dev)
        frames = _take_windows(video, start,
                               torch.arange(0, sample_size, 2))
        return frames, torch.ones((b, sample_size // 2), dtype=video.dtype,
                                  device=dev)
    mask = torch.zeros((b, sample_size), dtype=video.dtype, device=dev)
    mask[:, ::2] = 1.0
    return video[:, :sample_size], mask


def sample_regular_extrap(noise: Noise, video: torch.Tensor,
                          sample_size: int, train: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, t = video.shape[:2]
    dev = video.device
    start = (noise.randint(0, t - sample_size + 1, (b,), dev) if train
             else torch.zeros((b,), dtype=torch.long, device=dev))
    frames = _take_windows(video, start, torch.arange(sample_size))
    return frames, torch.ones((b, sample_size), dtype=video.dtype,
                              device=dev)


def _irregular_window(noise: Noise, video: torch.Tensor, window_size: int,
                      train: bool) -> torch.Tensor:
    b, t = video.shape[:2]
    start = (noise.randint(0, t - window_size, (b,), video.device)
             if train and t > window_size
             else torch.zeros((b,), dtype=torch.long, device=video.device))
    return _take_windows(video, start, torch.arange(window_size))


def _with_endpoints(mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    mask = mask.to(dtype)
    mask[:, 0] = 1.0
    mask[:, -1] = 1.0
    return mask


def sample_irregular_interp(noise: Noise, video: torch.Tensor,
                            sample_size: int, window_size: int,
                            train: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    frames = _irregular_window(noise, video, window_size, train)
    interior = _random_subset_mask(noise, video.shape[0], 1,
                                   window_size - 1, sample_size - 2,
                                   window_size, video.device)
    return frames, _with_endpoints(interior, video.dtype)


def sample_irregular_extrap(noise: Noise, video: torch.Tensor,
                            sample_size: int, window_size: int,
                            train: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    assert window_size % 2 == 0 and sample_size % 2 == 0
    b = video.shape[0]
    half_w, half_s = window_size // 2, sample_size // 2
    frames = _irregular_window(noise, video, window_size, train)
    m_in = _random_subset_mask(noise, b, 1, half_w, half_s - 1, window_size,
                               video.device)
    m_out = _random_subset_mask(noise, b, half_w, window_size - 1,
                                half_s - 1, window_size, video.device)
    return frames, _with_endpoints(m_in | m_out, video.dtype)


def sample(noise, video: torch.Tensor, sample_size: int,
           window_size: int = 20, irregular: bool = False,
           extrap: bool = True, train: bool = True):
    """The reference's ``sampling`` dispatch; ``noise`` a ``Noise`` or a
    ``torch.Generator``."""
    noise = as_noise(noise, "the window samplers")
    if not irregular:
        fn = sample_regular_extrap if extrap else sample_regular_interp
        return fn(noise, video, sample_size, train)
    fn = sample_irregular_extrap if extrap else sample_irregular_interp
    return fn(noise, video, sample_size, window_size, train)


def split_batch(frames: torch.Tensor, mask: torch.Tensor,
                extrap: bool) -> Dict[str, torch.Tensor]:
    """Extrapolation observes the first half of the window and predicts
    the second; interpolation observes the masked frames and predicts
    the whole window."""
    t = frames.shape[1]
    ts = torch.arange(0, t, dtype=torch.float32, device=frames.device) / t
    if extrap:
        half = t // 2
        return {"observed_data": frames[:, :half],
                "data_to_predict": frames[:, half:],
                "observed_mask": mask[:, :half],
                "mask_predicted_data": mask[:, half:],
                "observed_tp": ts[:half], "tp_to_predict": ts[half:]}
    return {"observed_data": frames * mask[:, :, None, None, None],
            "data_to_predict": frames, "observed_mask": mask,
            "mask_predicted_data": torch.ones_like(mask),
            "observed_tp": ts, "tp_to_predict": ts}
