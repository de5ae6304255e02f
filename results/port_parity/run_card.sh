#!/bin/bash
# The port's side of the ConvGRU matched-step parity runs, on one H100:
# the corpus (its sha256 held to chip_smoke.CORPUS_SHA256), chip_smoke
# phase 20 (its K3/K4 launches a step and loss gaps into phase20.json),
# then the 2000-step run from the committed JAX init and the same run
# from the init x (1 + 1e-7 noise): each `parity_init`, `main` and
# `parity_eval` (10 -> 10 and 10 -> 190 on 64 held-out videos), with
# each command's seconds in run.json. Run from the repo root on a host
# with one H100 (about 9 min; outputs under chiprun_out/port_parity/):
#
#     bash results/port_parity/run_card.sh
set -euo pipefail
export PYTHONPATH=$PWD
out=chiprun_out/port_parity
mkdir -p $out
host=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader)
echo "$host"
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
HOST="$host" python - <<'PY'
import json, os, pathlib, time
import chip_smoke as c
from ode_rl_torch import make_frozen_mmnist
t0 = time.perf_counter()
d = make_frozen_mmnist.main(["--out", "build/parity", *c.CORPUS_ARGS])
assert d == c.CORPUS_SHA256, d
print(f"corpus sha256 equal to chip_smoke.CORPUS_SHA256 ({time.perf_counter() - t0:.1f} s)")
c.phase_build()
r = c.phase_parity_init(pathlib.Path("build/parity"))
pathlib.Path("chiprun_out/port_parity/phase20.json").write_text(json.dumps({
    "host": os.environ["HOST"], "steps": c.PARITY_STEPS,
    "launches_a_step": {k: v / c.PARITY_STEPS for k, v in r["counts"].items() if v},
    "loss_gaps": r["gaps"], "grad_norm_gap_step1": r["grad_norm_gap"]}, indent=2))
PY

timed() {  # <command...>: run it, its seconds onto s
  echo "$*"
  SECONDS=0
  "$@"
  s+=($SECONDS)
}
cfg=(--configs defaults train_mmnist_cgru_len20 --frozen True --data_dir build/parity)
run() {  # <name> [parity_init flags]: one run into $out/<name>
  local name=$1; shift
  local logdir=build/parity_logs_$name ckpt=parity_cgru_$name
  local flags=("${cfg[@]}" --logdir $logdir --ckpt_id $ckpt)
  local init=(python -m ode_rl_torch.parity_init --params results/port_parity/convgru_init.npz "${flags[@]}" "$@")
  local train=(python -m ode_rl_torch.main "${flags[@]}" --steps_per_epoch 2000 --epochs 1 --loss_log_freq 50)
  local evaluate=(python -m ode_rl_torch.parity_eval --model ConvGRU --data build/parity --logdir $logdir --ckpt_id $ckpt --eval_outs 10,190 --eval_videos 64 --out $out/$name)
  s=()
  timed "${init[@]}"
  timed "${train[@]}"
  timed "${evaluate[@]}"
  cp $logdir/ConvGRU/ConvGRU_mmnist_train_10_10/metrics.jsonl $out/$name/train_metrics.jsonl
  HOST="$host" python - "$out/$name" "${s[@]}" "${init[*]}" "${train[*]}" "${evaluate[*]}" <<'PY'
import json, os, pathlib, sys, torch
out, *rest = sys.argv[1:]
seconds, commands = rest[:3], rest[3:]
names = ("parity_init", "main", "parity_eval")
metrics = json.loads((pathlib.Path(out) / "metrics.json").read_text())
assert metrics["step"] == 2000, metrics["step"]
(pathlib.Path(out) / "run.json").write_text(json.dumps({
    "commands": dict(zip(names, commands)),
    "host": os.environ["HOST"], "torch": torch.__version__,
    "seconds": dict(zip(names, map(int, seconds))), "steps": 2000,
    "launches": "K3/K4 a step: phase20.json, the same path in the same call"}, indent=2))
PY
}
run port
run port_noise --noise 1e-7
