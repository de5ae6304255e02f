"""Checkpoint manager.

Counterpart of ``ode_rl_tpu/core/checkpoint.py``: step-stamped snapshots
``<tag>_<step:010d>.ckpt`` of a run's state (model and optimizer state
dicts), written atomically, the newest ``keep`` kept, the config saved as
JSON beside them, and ``find_checkpoint`` to locate a run's directory by
its tag. The payload is ``torch.save`` of ``{"step", "state"}``, read back
with ``torch.load(weights_only=True)``, which unpickles tensors and plain
containers only, never arbitrary objects.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

_CKPT_RE = re.compile(r"^(?P<tag>.+)_(?P<step>\d{10})\.ckpt$")


class CheckpointManager:
    def __init__(self, directory: os.PathLike, tag: str = "ckpt",
                 keep: int = 5):
        self.directory = pathlib.Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.tag = tag
        self.keep = keep

    def _path(self, step: int) -> pathlib.Path:
        return self.directory / f"{self.tag}_{step:010d}.ckpt"

    def save(self, step: int, state: Dict[str, Any],
             config: Optional[Dict] = None) -> pathlib.Path:
        """Save ``state`` (a dict of state dicts) at ``step``."""
        path = self._path(step)
        tmp = path.with_suffix(".tmp")
        torch.save({"step": int(step), "state": state}, tmp)
        tmp.replace(path)  # atomic on POSIX
        if config is not None:
            cfg_path = self.directory / f"{self.tag}_config.json"
            cfg_path.write_text(json.dumps(config, default=str, indent=2))
        self._gc()
        return path

    def _gc(self) -> None:
        steps = self.all_steps()
        for step in steps[:-self.keep] if self.keep > 0 else []:
            self._path(step).unlink(missing_ok=True)

    def all_steps(self) -> List[int]:
        steps = []
        for p in self.directory.glob(f"{self.tag}_*.ckpt"):
            m = _CKPT_RE.match(p.name)
            if m and m.group("tag") == self.tag:
                steps.append(int(m.group("step")))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: Dict[str, Any], step: Optional[int] = None,
                allow_missing: Tuple[str, ...] = ()) -> Dict[str, Any]:
        """Load the snapshot at ``step`` (the newest by default), checked
        against the structure of ``target``, a dict of state dicts.

        Top-level fields named in ``allow_missing`` may be absent from the
        snapshot and keep the target's values. Any other gap, or a tensor
        of another shape (a model of another architecture or width),
        raises: training on fresh weights while claiming a resume would
        corrupt the run. Returns ``{"step": int, "state": dict}``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = self._path(step)
        raw = torch.load(path, map_location="cpu", weights_only=True)
        merged, missing = _merge_state(target, raw["state"], "")
        fatal = [p for p in missing if not (
            p.count("/") == 1 and p[1:] in allow_missing)]
        if fatal:
            raise ValueError(
                f"checkpoint {path} is structurally incompatible with the "
                f"current model/optimizer: {fatal[:8]}"
                f"{'...' if len(fatal) > 8 else ''}")
        if missing:
            print(f"checkpoint {path.name}: keeping fresh values for fields "
                  f"absent in snapshot: {missing}")
        return {"step": int(raw["step"]), "state": merged}

    def load_config(self) -> Optional[Dict[str, Any]]:
        """The config saved beside the checkpoints, or None."""
        cfg_path = self.directory / f"{self.tag}_config.json"
        if not cfg_path.exists():
            return None
        return json.loads(cfg_path.read_text())


def _merge_state(target, snapshot, path: str):
    """Overlay ``snapshot`` on ``target``; returns (merged, problems):
    the paths the snapshot lacks, holds with another tensor shape, or
    holds beyond a non-empty dict of the target (a state dict of another
    model). An empty dict of the target, such as a fresh optimizer's
    state, takes the snapshot's; extra top-level fields are ignored."""
    if torch.is_tensor(target) and torch.is_tensor(snapshot):
        if target.shape != snapshot.shape:
            return snapshot, [f"{path} (shape {tuple(snapshot.shape)}, "
                              f"expected {tuple(target.shape)})"]
        return snapshot, []
    if not isinstance(target, dict) or not isinstance(snapshot, dict):
        return snapshot, []
    if not target:
        return snapshot, []
    merged, problems = {}, []
    for k, v in target.items():
        if k in snapshot:
            merged[k], sub = _merge_state(v, snapshot[k], f"{path}/{k}")
            problems.extend(sub)
        else:
            merged[k] = v
            problems.append(f"{path}/{k}")
    if path:
        problems.extend(f"{path}/{k} (not in the target)"
                        for k in snapshot if k not in target)
    return merged, problems


def find_checkpoint(logdir: os.PathLike, model: str,
                    ckpt_id: str) -> pathlib.Path:
    """The checkpoint directory of ``ckpt_id``: scan
    ``<logdir>/<model>/*/checkpoints`` for step-stamped files whose tag is
    exactly ``ckpt_id``; the newest step wins. Raises FileNotFoundError
    with the directories found when nothing matches."""
    root = pathlib.Path(logdir) / model
    hits = []
    for p in root.glob(f"*/checkpoints/{ckpt_id}_*.ckpt"):
        m = _CKPT_RE.match(p.name)
        if m and m.group("tag") == ckpt_id:
            hits.append(p)
    if not hits:
        available = sorted({q.parent
                            for q in root.glob("*/checkpoints/*.ckpt")})
        raise FileNotFoundError(
            f"no checkpoint with ckpt_id={ckpt_id!r} under "
            f"{root}/*/checkpoints; found checkpoint dirs: "
            f"{[str(a) for a in available] or 'none'}")
    return max(hits, key=lambda p: p.name).parent
