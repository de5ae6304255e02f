"""How far training runs drift apart under rounding-sized differences:
the numbers behind two tolerances of the port's recurrent tests.

1. ``drift``: three train steps of ConvGRU, cgrudecODE and ConvGRU with
   clip and adamax, as ``test_three_train_steps_match_jax`` runs them
   (32 channels, batch 2, 16x16 frames, 4 -> 4 frames), with no
   re-sync. After each step it prints the worst parameter leaf's
   relative L2 distance between the port and JAX, and, for cgrudecODE,
   between each package's run and its own run from the initial
   parameters multiplied by 1 + 1e-7 noise (four draws).
2. ``kl``: the sampled z0 block's gradients in fp32 against the same
   model in fp64 (the noise drawn in fp32 on both), at the full width
   (64 channels, batch 4, 64x64 frames, 10 -> 10), with its KL term and
   with ``z_kl_weight`` 0: the worst leaf in the z0 head, in the other
   leaves the KL term reaches (the conv encoder and the z0 encoder),
   and in the rest.

Run from the repo root on the CPU (a few minutes):

    JAX_PLATFORMS=cpu python tests/torch_port_drift.py [drift|kl]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_port_recurrent_train as T  # noqa: E402
from torch_port_util import rel_l2, t32  # noqa: E402
from ode_rl_torch.convert import flax_to_torch  # noqa: E402
from ode_rl_torch.core.config import load_config  # noqa: E402
from ode_rl_torch.data.mmnist import generate_moving_mnist  # noqa: E402
from ode_rl_torch.data.protocol import make_batch_dict  # noqa: E402
from ode_rl_torch.data.sprites import get_sprite_bank  # noqa: E402
from ode_rl_torch.parity_init import perturb  # noqa: E402
from ode_rl_torch.train.step import (create_train_state,  # noqa: E402
                                     loss_and_grads, make_train_step)


def _worst(a, b):
    return max(rel_l2(a[n], b[n]) for n in a)


def drift():
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    from ode_rl_tpu.train.step import make_train_step as jax_train

    videos = T._videos()
    for block, overrides in (("train_mmnist_cgru_len20", {}),
                             ("train_mmnist_cgrudecODE", {}),
                             ("train_mmnist_cgru_len20",
                              {"clip": 0.005, "optimizer": "adamax"})):
        blocks = ["defaults", block]
        model, j0 = T._jax_state(blocks, overrides, videos[0])
        jstep, step = jax_train(model, donate=False), make_train_step()

        def port_run(seed=None):
            state = T._port_state(blocks, overrides, j0.params)
            if seed is not None:
                perturb(state.model, 1e-7, seed)
            start = T._as_flax(state.model, j0.params)
            out = []
            for video in videos:
                step(state, make_batch_dict(t32(video), T.T_IN))
                out.append({n: p.detach().clone()
                            for n, p in state.model.named_parameters()})
            return start, out

        def jax_run(params):
            jstate, out = j0.replace(params=params), []
            for video in videos:
                jstate, _ = jstep(jstate, jax_batch(jnp.asarray(video),
                                                    n_in=T.T_IN), None)
                out.append(flax_to_torch(jax.tree_util.tree_map(
                    np.asarray, jstate.params)))
            return out

        _, port = port_run()
        ref = jax_run(j0.params)
        print(f"{block} {overrides}: port against JAX after steps 1-3: "
              + ", ".join(f"{_worst(p, j):.2e}" for p, j in zip(port, ref)))
        if block != "train_mmnist_cgrudecODE":
            continue
        for seed in range(4):
            start, port_p = port_run(seed)
            ref_p = jax_run(start)
            print(f"  x(1 + 1e-7 noise), draw {seed}: port against port "
                  + ", ".join(f"{_worst(a, b):.2e}"
                              for a, b in zip(port_p, port))
                  + "; JAX against JAX "
                  + ", ".join(f"{_worst(a, b):.2e}"
                              for a, b in zip(ref_p, ref)), flush=True)


def kl():
    randn = torch.randn

    def randn_fp32(*args, dtype=None, **kwargs):
        # The same noise for the fp32 and the fp64 model.
        return randn(*args, dtype=torch.float32, **kwargs).to(
            dtype or torch.float32)

    torch.randn = randn_fp32
    cfg = load_config(["defaults", "train_mmnist_sample_odecgru"],
                      overrides={"batch_size": 4, "train_in_seq": 10,
                                 "train_out_seq": 10})
    bank = torch.from_numpy(get_sprite_bank(cfg.data_dir)).float()
    video = generate_moving_mnist(torch.Generator().manual_seed(2), bank,
                                  batch=4, n_frames=20, num_digits=3)
    batch = make_batch_dict(video, 10)
    batch64 = {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
               else v for k, v in batch.items()}

    def grads(model, b):
        loss_and_grads(model, b, torch.Generator().manual_seed(7))
        return {n: p.grad.double() for n, p in model.named_parameters()}

    def group(name):
        if name.startswith("z0_encoder.head"):
            return "z0 head"
        if name.startswith(("conv_encoder.", "z0_encoder.")):
            return "reached"
        return "rest"

    for weight in (cfg.z_kl_weight, 0.0):
        for seed in (0, 1):
            model = create_train_state(cfg.replace(seed=seed,
                                                   z_kl_weight=weight),
                                       torch.device("cpu")).model
            g32 = grads(model, batch)
            model = model.double()
            for mod in model.modules():
                if getattr(mod, "dtype", None) == torch.float32:
                    mod.dtype = torch.float64
            g64 = grads(model, batch64)
            worst = {}
            for n in g32:
                err = rel_l2(g32[n], g64[n])
                if err > worst.get(group(n), (0.0, ""))[0]:
                    worst[group(n)] = (err, n)
            print(f"z_kl_weight {weight}, seed {seed}: fp32 against fp64, "
                  + "; ".join(f"{g} {e:.2e} ({n})"
                              for g, (e, n) in sorted(worst.items())),
                  flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    modes = sys.argv[1:] or ["drift", "kl"]
    for mode in modes:
        {"drift": drift, "kl": kl}[mode]()
