"""Profiling helpers: a tensor recorder, a step timer and trace capture.

Counterpart of ``ode_rl_tpu/core/profiler.py``:

* ``Tracker``: the intermediate-tensor recorder (write/export/clean);
* ``StepTimer``: wall-clock step times after ``warmup`` steps, summarised
  as mean, p50 and p95 in ms and steps a second. On a CUDA device
  ``tick`` first waits for the device (``torch.cuda.synchronize``), so a
  step's time includes its kernels, not only their launch;
* ``trace(logdir)``: ``torch.profiler`` (CPU and, where there is a card,
  CUDA activities) around the block, written as a Chrome trace
  ``<logdir>/trace.json``; ``annotate(name)`` is ``record_function``, a
  named span in that trace.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch


class Tracker:
    """Intermediate-tensor recorder."""

    def __init__(self):
        self.infos: Dict[str, Any] = {}

    def write_info(self, key: str, value: Any) -> None:
        self.infos[key] = value

    def export_info(self) -> Dict[str, Any]:
        return dict(self.infos)

    def clean_info(self) -> None:
        self.infos = {}


class StepTimer:
    """Wall-clock step timing with a percentile summary of the steps
    after ``warmup``; ``tick`` once a step."""

    def __init__(self, warmup: int = 3, device: Optional[torch.device] = None):
        self.warmup = warmup
        self.device = torch.device("cpu") if device is None else device
        self._times: List[float] = []
        self._count = 0
        self._last: Optional[float] = None

    def tick(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.warmup:
                self._times.append(now - self._last)
        self._last = now

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "steps_per_sec": float(1.0 / arr.mean()),
        }


@contextlib.contextmanager
def trace(logdir, enabled: bool = True
          ) -> Iterator[Optional[torch.profiler.profile]]:
    """Profile the block into ``<logdir>/trace.json`` (open with Perfetto
    or chrome://tracing); yields the profiler, or None where not
    ``enabled``."""
    if not enabled:
        yield None
        return
    logdir = pathlib.Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


def annotate(name: str) -> torch.profiler.record_function:
    """A named span in the profiler's timeline."""
    return torch.profiler.record_function(name)
