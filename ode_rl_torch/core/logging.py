"""Host-side metric logging: stdout and ``metrics.jsonl``.

Counterpart of ``ode_rl_tpu/core/logging.py``: one JSON line a logged
step, the experiment banner and the per-epoch line with its rate and
ETA. wandb is used only where ``off_wandb`` is False and the package is
installed, as in JAX; the configs keep it off.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _to_py(v: Any) -> Any:
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    arr = np.asarray(v)
    return arr.item() if arr.ndim == 0 else arr.tolist()


class MetricLogger:
    def __init__(self, logdir: Optional[pathlib.Path] = None,
                 use_wandb: bool = False,
                 wandb_kwargs: Optional[Dict] = None, quiet: bool = False):
        self.logdir = pathlib.Path(logdir) if logdir is not None else None
        self.quiet = quiet
        self._jsonl = None
        if self.logdir is not None:
            self.logdir.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(self.logdir / "metrics.jsonl", "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                print("off_wandb is False but wandb is not installed; "
                      "logging to metrics.jsonl only")
            else:
                self._wandb = wandb
                self._wandb.init(**(wandb_kwargs or {}))
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any],
            prefix: str = "") -> None:
        payload = {f"{prefix}{k}": _to_py(v) for k, v in metrics.items()}
        payload["step"] = step
        payload["wall_s"] = round(time.time() - self._t0, 2)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(payload) + "\n")
            self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(payload, step=step)
        if not self.quiet:
            body = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in payload.items() if k not in ("step", "wall_s"))
            print(f"[step {step}] {body}", flush=True)

    def print_exp_details(self, cfg, n_train_batches: int) -> None:
        """Experiment banner."""
        keys = ("model", "dataset", "phase", "batch_size", "epochs", "lr",
                "train_in_seq", "train_out_seq", "decode_diff_method",
                "compute_dtype")
        body = " | ".join(f"{k}={cfg.get(k)}" for k in keys
                          if cfg.get(k) is not None)
        print("=" * 72)
        print(f"Experiment: {cfg.get('id', '?')}")
        print(body)
        print(f"{n_train_batches} batches/epoch x {cfg.get('epochs', '?')} "
              f"epochs")
        print("=" * 72, flush=True)

    def log_epoch(self, epoch: int, epoch_loss: float, step: int,
                  total_steps: int) -> None:
        elapsed = time.time() - self._t0
        rate = step / max(elapsed, 1e-9)
        eta = (total_steps - step) / max(rate, 1e-9)
        print(f"epoch {epoch} | loss {epoch_loss:.6f} | step {step}/"
              f"{total_steps} | {rate:.2f} steps/s | eta {eta / 60:.1f} min",
              flush=True)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
