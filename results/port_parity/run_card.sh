#!/bin/bash
# The port's side of a matched-step parity run, on one H100: the corpus
# (its sha256 held to chip_smoke.CORPUS_SHA256), chip_smoke phase 20 (its
# launches a step and loss gaps into phase20.json), then the run from the
# committed JAX init and the same run from the init x (1 + 1e-7 noise):
# each `parity_init`, `main` and `parity_eval` (64 held-out videos), with
# each command's seconds in run.json. The first argument chooses the
# model:
#
#   convgru  the ConvGRU twin, 2000 steps, 10 -> 10 and 10 -> 190, the two
#            runs one after the other, outputs under
#            chiprun_out/port_parity/ (about 9 min);
#   recipe   the recipe (ODE-ConvGRU), N steps (the second argument, a
#            multiple of 250 from 1000 to 2000, default 2000: the step
#            JAX's run was stopped at), a checkpoint every 250 steps,
#            10 -> 10 and 10 -> 90, outputs under
#            chiprun_out/port_parity/recipe/. The two runs go side by
#            side, each its own process and log (the step is host-bound
#            and the host has 8 cores).
#
# Run from the repo root on a host with one H100:
#
#     bash results/port_parity/run_card.sh convgru
#     bash results/port_parity/run_card.sh recipe [N]
set -euo pipefail
export PYTHONPATH=$PWD
model=${1:?convgru or recipe}
case $model in
  convgru)
    out=chiprun_out/port_parity
    cfg=(--configs defaults train_mmnist_cgru_len20)
    net=ConvGRU eval_outs=10,190 ckpt=parity_cgru init=convgru_init.npz
    every=() n=2000 ;;
  recipe)
    out=chiprun_out/port_parity/recipe
    cfg=(--configs defaults train_mmnist_odecgru_len20_1ch)
    net=ODEConv eval_outs=10,90 ckpt=parity_odecgru init=odecgru_init.npz
    every=(--ckpt_save_freq 250) n=${2:-2000} ;;
  *) echo "unknown model $model: convgru or recipe" >&2; exit 2 ;;
esac
cfg+=(--frozen True --data_dir build/parity)
mkdir -p $out
host=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader)
echo "$host"
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
HOST="$host" MODEL=$model OUT=$out python - <<'PY'
import json, os, pathlib, time
import chip_smoke as c
from ode_rl_torch import make_frozen_mmnist
t0 = time.perf_counter()
d = make_frozen_mmnist.main(["--out", "build/parity", *c.CORPUS_ARGS])
assert d == c.CORPUS_SHA256, d
print(f"corpus sha256 equal to chip_smoke.CORPUS_SHA256 ({time.perf_counter() - t0:.1f} s)")
c.phase_build()
r = c.phase_parity_init(pathlib.Path("build/parity"))
r = r["twin" if os.environ["MODEL"] == "convgru" else "recipe"]
record = {"host": os.environ["HOST"], "steps": c.PARITY_STEPS,
          "launches_a_step": {k: v / c.PARITY_STEPS
                              for k, v in r["counts"].items() if v},
          "loss_gaps": r["gaps"], "grad_norm_gap_step1": r["grad_norm_gap"]}
if "nfe" in r["jax_logged"][0]:
    record["nfe"] = [m["nfe"] for m in r["logged"]]
    record["jax_nfe"] = [m["nfe"] for m in r["jax_logged"]]
pathlib.Path(os.environ["OUT"], "phase20.json").write_text(
    json.dumps(record, indent=2))
PY

timed() {  # <command...>: run it, its seconds onto s
  echo "$*"
  SECONDS=0
  "$@"
  s+=($SECONDS)
}
run() {  # <name> [parity_init flags]: one run into $out/<name>
  local name=$1; shift
  local logdir=build/parity_logs_$name id=${ckpt}_$name
  local flags=("${cfg[@]}" --logdir $logdir --ckpt_id $id)
  local init=(python -m ode_rl_torch.parity_init --params results/port_parity/$init "${flags[@]}" "$@")
  local train=(python -m ode_rl_torch.main "${flags[@]}" --steps_per_epoch $n --epochs 1 --loss_log_freq 50 "${every[@]}")
  local evaluate=(python -m ode_rl_torch.parity_eval --model $net --data build/parity --logdir $logdir --ckpt_id $id --eval_outs $eval_outs --eval_videos 64 --out $out/$name)
  s=()
  timed "${init[@]}"
  timed "${train[@]}"
  timed "${evaluate[@]}"
  cp $logdir/$net/${net}_mmnist_train_10_10/metrics.jsonl $out/$name/train_metrics.jsonl
  HOST="$host" N=$n python - "$out/$name" "${s[@]}" "${init[*]}" "${train[*]}" "${evaluate[*]}" <<'PY'
import json, os, pathlib, sys, torch
out, *rest = sys.argv[1:]
seconds, commands = rest[:3], rest[3:]
names = ("parity_init", "main", "parity_eval")
n = int(os.environ["N"])
metrics = json.loads((pathlib.Path(out) / "metrics.json").read_text())
assert metrics["step"] == n, (metrics["step"], n)
(pathlib.Path(out) / "run.json").write_text(json.dumps({
    "commands": dict(zip(names, commands)),
    "host": os.environ["HOST"], "torch": torch.__version__,
    "seconds": dict(zip(names, map(int, seconds))), "steps": n,
    "launches": "a step: phase20.json, the same path in the same call"},
    indent=2))
PY
}
if [ $model = convgru ]; then
  run port
  run port_noise --noise 1e-7
  exit
fi
echo "the two runs side by side: $out/port.log, $out/port_noise.log"
run port > $out/port.log 2>&1 &
port=$!
run port_noise --noise 1e-7 > $out/port_noise.log 2>&1 &
wait $port
wait $!
tail -n 4 $out/*.log
