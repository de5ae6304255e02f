"""Compare matched-step parity runs: each run's held-out metrics and train
losses against a reference run's.

    python -m ode_rl_torch.parity_compare --ref results/port_parity/jax \\
        --runs results/port_parity/port results/port_parity/port_noise \\
        [--pairs port:port_noise] [--out results/port_parity/summary.json]

A run is a directory with parity_eval's (or ``scripts/jax_parity_eval.py``'s)
``metrics.json`` and the train log ``train_metrics.jsonl``. For each run
against the reference, and for each ``--pairs`` ``a:b`` (run ``b`` against
run ``a``, by directory name):

- ``delta_pct``: 100 (run - ref) / ref on the mean MSE over the horizons
  of each evaluation (``10to10``: 1..10, ``10to190``: 1..190);
- ``max_abs_delta_pct``: the largest |100 (run - ref) / ref| of the MSE
  at any one horizon of each evaluation, and that horizon (from 1);
- ``loss``: both train losses at steps 500, 1000 and 2000, and their
  relative gap in percent.

Prints one line a comparison and writes them all to ``--out`` as JSON.
Needs numpy only.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, Optional, Sequence

import numpy as np

STEPS = (500, 1000, 2000)


def read_run(path) -> Dict:
    path = pathlib.Path(path)
    metrics = json.loads((path / "metrics.json").read_text())
    losses = {}
    for line in (path / "train_metrics.jsonl").read_text().splitlines():
        row = json.loads(line)
        if "loss" in row:
            losses[int(row["step"])] = float(row["loss"])
    return {"metrics": metrics, "losses": losses}


def compare(run: Dict, ref: Dict, steps: Sequence[int]) -> Dict:
    out = {"step": [run["metrics"]["step"], ref["metrics"]["step"]],
           "delta_pct": {}, "max_abs_delta_pct": {}, "mean_mse": {},
           "loss": {}}
    for key, value in ref["metrics"].items():
        if not isinstance(value, dict):
            continue
        a = np.asarray(run["metrics"][key]["mse"], np.float64)
        b = np.asarray(value["mse"], np.float64)
        if a.shape != b.shape:
            raise ValueError(f"{key}: {a.shape} horizons against {b.shape}")
        out["mean_mse"][key] = [float(a.mean()), float(b.mean())]
        out["delta_pct"][key] = float(100 * (a.mean() - b.mean()) / b.mean())
        per = np.abs(100 * (a - b) / b)
        out["max_abs_delta_pct"][key] = [float(per.max()),
                                         int(per.argmax()) + 1]
    for s in steps:
        a, b = run["losses"][s], ref["losses"][s]
        out["loss"][str(s)] = [a, b, 100 * (a - b) / b]
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", required=True)
    ap.add_argument("--runs", nargs="+", required=True)
    ap.add_argument("--pairs", nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    ref_name = pathlib.Path(args.ref).name
    runs = {pathlib.Path(p).name: read_run(p) for p in args.runs}
    runs[ref_name] = read_run(args.ref)
    pairs = [(ref_name, name) for name in runs if name != ref_name]
    pairs += [tuple(p.split(":")) for p in args.pairs]
    summary = {}
    for a, b in pairs:
        row = summary[f"{b} against {a}"] = compare(runs[b], runs[a], STEPS)
        print(f"{b} against {a}: delta % of mean MSE "
              + ", ".join(f"{k} {v:+.3f}" for k, v in row["delta_pct"].items())
              + "; largest |delta| % at a horizon "
              + ", ".join(f"{k} {v[0]:.3f} (h{v[1]})"
                          for k, v in row["max_abs_delta_pct"].items())
              + "; train loss gap % at steps "
              + ", ".join(f"{k} {v[2]:+.3f}" for k, v in row["loss"].items()))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
