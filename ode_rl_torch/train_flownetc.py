"""Train a FlowNet on the synthetic stream and score it on a held-out
FlyingChairs-layout corpus.

    python -m ode_rl_torch.train_flownetc [--net C|S|2] [--steps 2000]
        [--batch 8] [--lr 1e-4] [--val_pairs 64] [--warm_start]
        [--flow_dir logs/flow] [--out PATH] [--report PATH]
        [--device cuda]

Counterpart of ``scripts/train_flownetc.py``, with its flags and
defaults. The DFP labels of S3VAE's ``flow_label_source: flownet`` come
from a trained FlowNetC, so this trains one on the 'digits' synthetic
stream (flow/train.py), writes a held-out corpus of ``--val_pairs``
pairs from seed 1234 into a temporary directory (all of it held out:
``train_split=0.0``), reports the EPE there of the net at its random
initialisation and after training, and saves the weights where
``flownet_params_path`` looks by default, ``{flow_dir}/flownetc.msgpack``
(JAX's file format, so either package reads them). ``--net S`` trains
FlowNetS (the channel-stacked pair) into ``flownets.msgpack``; ``--net
2`` the stacked FlowNet2 with the single-scale L1 loss on its fusion
output into ``flownet2.msgpack``, and with ``--warm_start`` first grafts
``{flow_dir}/flownetc.msgpack`` into ``css.flownetcs.flownetc`` and
``{flow_dir}/flownets.msgpack`` into ``css.flownetcs.flownets1`` and
``css.flownets2`` (the reference's staged schedule; the counts of copied
and shape-skipped leaves go into the report with the warm start's EPE).

The net trains from the weights whose random-init EPE it reports (JAX
draws those from one key and the training start from another). The
report goes to ``results/torch/{flownetc,flownets,flownet2}.json`` with
the script's keys plus ``device``. ``--flow_dir`` is the port's own flag;
JAX's script reads and writes ``logs/flow``. ``--device`` defaults to
``cuda``, and a host without CUDA raises rather than fall back to the
CPU. TF32 is off, as in ``ode_rl_torch.main``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from ode_rl_torch.core.device import resolve_device
from ode_rl_torch.flow.data import (FlyingChairsCorpus, validate_epe,
                                    write_synthetic_chairs)
from ode_rl_torch.flow.flownets import FlowNet2, FlowNetC, FlowNetS
from ode_rl_torch.flow.train import (graft_params, load_flownet_params,
                                     save_flownet_params, train_flownet)

TAGS = {"C": "flownetc", "S": "flownets", "2": "flownet2"}
NETS = {"C": FlowNetC, "S": FlowNetS, "2": FlowNet2}
# The held-out corpus's seed (JAX's script writes it from the same).
VAL_SEED = 1234


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", choices=["C", "S", "2"], default="C")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--report", default=None)
    ap.add_argument("--val_pairs", type=int, default=64)
    ap.add_argument("--warm_start", action="store_true",
                    help="(--net 2 only) graft the separately trained "
                         "FlowNetC/FlowNetS weights into the stack first")
    ap.add_argument("--flow_dir", default="logs/flow")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _warm_start(net: FlowNet2, flow_dir: pathlib.Path) -> Dict:
    """Graft the FlowNetC and FlowNetS donors into the stack; returns
    {sub-net: [grafted, skipped]}."""
    donor_c = load_flownet_params(flow_dir / "flownetc.msgpack")["params"]
    donor_s = load_flownet_params(flow_dir / "flownets.msgpack")["params"]
    info = {}
    for name, sub, donor in (
            ("flownetc", net.css.flownetcs.flownetc, donor_c),
            ("flownets1", net.css.flownetcs.flownets1, donor_s),
            ("flownets2", net.css.flownets2, donor_s)):
        state, grafted, skipped = graft_params(sub, donor)
        sub.load_state_dict(state)
        info[name] = [grafted, skipped]
    return info


def run(args: argparse.Namespace) -> Tuple[Dict, torch.nn.Module]:
    """The run ``main`` makes: (the report, the trained net)."""
    device = resolve_device(args.device)
    tag = TAGS[args.net]
    flow_dir = pathlib.Path(args.flow_dir)
    out_path = pathlib.Path(args.out or flow_dir / f"{tag}.msgpack")
    report_path = pathlib.Path(args.report or f"results/torch/{tag}.json")
    if args.warm_start and args.net != "2":
        raise ValueError("--warm_start is the FlowNet2 staging path "
                         "(--net 2)")
    # FlowNetS takes the channel-stacked pair; FlowNetC and FlowNet2 the
    # two images. FlowNet2 gives one full-resolution flow.
    pair_input = args.net == "S"
    single_scale = args.net == "2"
    net = NETS[args.net](generator=torch.Generator().manual_seed(0)).to(
        device)

    with tempfile.TemporaryDirectory(prefix="chairs_val_") as val_dir:
        write_synthetic_chairs(val_dir, n_pairs=args.val_pairs,
                               seed=VAL_SEED, device=device)

        def val():
            return FlyingChairsCorpus(val_dir, batch_size=args.batch,
                                      is_train=False, train_split=0.0,
                                      seed=0)

        def score() -> float:
            return validate_epe(net, val(), pair_input=pair_input,
                                single_scale=single_scale)

        n_eval_pairs = len(val()) * args.batch
        rand_epe = score()
        print(f"random-init FlowNet{args.net} val EPE: {rand_epe:.4f}")
        graft_info = None
        if args.warm_start:
            graft_info = _warm_start(net, flow_dir)
            graft_info["val_epe_warm_start"] = score()
            print(f"warm-start grafts (copied, shape-skipped): {graft_info}")

        t0 = time.time()
        out = train_flownet(net, steps=args.steps, batch=args.batch,
                            lr=args.lr, pair_input=pair_input,
                            single_scale=single_scale)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_s = time.time() - t0
        trained_epe = score()
    print(f"trained  FlowNet{args.net} val EPE: {trained_epe:.4f} "
          f"(final train loss {out['loss']:.4f}, epe {out['epe']:.4f}; "
          f"{args.steps} steps in {train_s:.0f}s)")
    save_flownet_params(net, out_path)
    print(f"saved params → {out_path}")

    report = {
        "net": f"FlowNet{args.net}",
        "steps": args.steps, "batch": args.batch, "lr": args.lr,
        "train_seconds": round(train_s, 1),
        "final_train_loss": out["loss"], "final_train_epe": out["epe"],
        "val_epe_random_init": rand_epe, "val_epe_trained": trained_epe,
        "val_pairs": args.val_pairs, "val_pairs_evaluated": n_eval_pairs,
        "params_path": str(out_path),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    if graft_info is not None:
        report["warm_start"] = graft_info
    report_path.parent.mkdir(parents=True, exist_ok=True)
    report_path.write_text(json.dumps(report, indent=2) + "\n")
    print(f"report → {report_path}")
    return report, net


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    return run(parse_args(argv))[0]


if __name__ == "__main__":
    main()
