"""One initial train state for a matched-step parity run of both packages.

Builds the train state exactly as JAX's ``main.py`` does for the given
``--configs`` and flags (``ode_rl_tpu/train/loop.py::setup``: the model's
init from ``seed``, Adam's fresh state), saves it as JAX's own step-0
checkpoint under ``<logdir>/<model>/<run id>/checkpoints`` with the run's
``ckpt_id``, so that ``main.py`` with the same flags resumes from it at
step 0, and writes its params as a float32 ``.npz`` (the leaves' paths
joined with ``/``). ``python -m ode_rl_torch.parity_init`` reads that
``.npz`` and writes the port's step-0 checkpoint from it.

Run from the repo root on the CPU (a few seconds):

    JAX_PLATFORMS=cpu python tests/torch_port_parity_init.py \\
        --npz results/port_parity/convgru_init.npz \\
        --configs defaults train_mmnist_cgru_len20 --frozen True \\
        --data_dir datasets/parity --logdir logs/parity_jax \\
        --ckpt_id parity_cgru_jax

Not collected by pytest; ``tests/test_torch_port_parity_init.py`` calls
``write_jax_init``.
"""

import argparse
import os
import pathlib
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def flat_params(params) -> dict:
    """The flax params tree as {'a/b/kernel': float32 array}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out[name] = np.asarray(leaf, np.float32)
    return out


def write_jax_init(argv, npz) -> pathlib.Path:
    """JAX's step-0 checkpoint for ``main.py`` with ``argv`` and the
    params' ``.npz`` at ``npz``; returns the checkpoint's path."""
    from main import get_cfg
    from ode_rl_tpu.core.checkpoint import CheckpointManager
    from ode_rl_tpu.core.config import resolve_run_id
    from ode_rl_tpu.train.loop import setup

    cfg = get_cfg(list(argv))
    if cfg.phase != "train":
        raise ValueError("the init is a train run's")
    logdir = (pathlib.Path(cfg.get("logdir", "logs")) / cfg.model
              / resolve_run_id(cfg))
    ckpt = CheckpointManager(logdir / "checkpoints",
                             tag=cfg.get("ckpt_id", resolve_run_id(cfg)))
    if ckpt.latest_step() is not None:
        raise FileExistsError(f"{ckpt.directory} already holds checkpoints")
    _, _, state, _ = setup(cfg)
    path = ckpt.save(0, {"params": state.params,
                         "model_state": state.model_state,
                         "opt_state": state.opt_state},
                     config=cfg.to_dict())
    npz = pathlib.Path(npz)
    npz.parent.mkdir(parents=True, exist_ok=True)
    np.savez(npz, **flat_params(state.params))
    return path


def main():
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--npz", required=True)
    args, rest = ap.parse_known_args()
    path = write_jax_init(rest, args.npz)
    print(f"wrote {path} and {args.npz}")


if __name__ == "__main__":
    main()
