"""The ODE decode's counts in JAX's held-out evaluation of a parity run.

``scripts/jax_parity_eval.py`` writes the per-horizon metrics and drops
the model's ``aux_*`` stats. This runs the same evaluation (the same
checkpoint, test videos 0..N-1 windowed at frame 0, key 0 at every
batch) and writes those stats as ``python -m ode_rl_torch.parity_eval``
writes the port's: ``<out>/ode.json``, {"<n_in>to<n_out>":
``parity_eval.solve_summary``}, the most NFE, accepted steps and
attempts of a solve and the number of solves that stopped short.

Run from the repo root on the CPU, with the script's flags:

    JAX_PLATFORMS=cpu python tests/torch_port_jax_eval_ode.py \\
        --eval_outs 10,90 --eval_videos 64 --data datasets/parity \\
        --ckpt_id parity_odecgru_jax --logdir logs/parity_jax_recipe \\
        --out results/port_parity/recipe/jax

Not collected by pytest.
"""

import argparse
import json
import os
import pathlib
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default="datasets/parity")
    ap.add_argument("--ckpt_id", default="parity_odecgru_jax")
    ap.add_argument("--logdir", default="logs")
    ap.add_argument("--model", default="ODEConv")
    ap.add_argument("--n_in", type=int, default=10)
    ap.add_argument("--eval_outs", default="10,90")
    ap.add_argument("--eval_videos", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    from ode_rl_torch.parity_eval import held_out_videos, solve_summary
    from ode_rl_tpu.core.checkpoint import CheckpointManager, find_checkpoint
    from ode_rl_tpu.core.config import Config
    from ode_rl_tpu.data.protocol import make_batch_dict
    from ode_rl_tpu.models import build_model
    from ode_rl_tpu.train.step import create_train_state, make_eval_step

    ckpt = CheckpointManager(
        find_checkpoint(args.logdir, args.model, args.ckpt_id),
        tag=args.ckpt_id)
    cfg = Config(ckpt.load_config())
    model = build_model(cfg)
    eval_step = make_eval_step(model)
    videos = held_out_videos(pathlib.Path(args.data), args.eval_videos)

    variables, ode = None, {}
    for n_out in [int(x) for x in args.eval_outs.split(",")]:
        solves = []
        for b0 in range(0, args.eval_videos, args.batch):
            clip = videos[b0:b0 + args.batch, :args.n_in + n_out]
            video = clip.astype(np.float32)[..., None] / 255.0 - 0.5
            batch = make_batch_dict(jax.numpy.asarray(video), n_in=args.n_in)
            if variables is None:
                state = create_train_state(model, cfg, batch,
                                           jax.random.key(0))
                restored = ckpt.restore({"params": state.params,
                                         "model_state": state.model_state,
                                         "opt_state": state.opt_state})
                variables = {"params": restored["state"]["params"],
                             **restored["state"]["model_state"]}
                print(f"loaded {args.ckpt_id} step {restored['step']}")
            metrics, _ = eval_step(variables, batch, jax.random.key(0))
            solves.append({k[4:]: int(v) for k, v in metrics.items()
                           if k.startswith("aux_")})
        ode[f"{args.n_in}to{n_out}"] = solve_summary(solves)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "ode.json").write_text(json.dumps(ode, indent=2))
    print("ODE solves:", ode)


if __name__ == "__main__":
    main()
