"""Where a fused training step spends its time on one card.

    python -m ode_rl_torch.profile_step --net flagship  # FlagshipConfig
    python -m ode_rl_torch.profile_step --net recipe  # the recipe
    python -m ode_rl_torch.profile_step --net C   # FlowNetCBenchConfig
    python -m ode_rl_torch.profile_step --net 2   # FlowNet2Config

``flagship`` is the B=128 bf16 bench step (``defaults`` +
``tpu_bench_odecgru``); ``recipe`` is the training recipe users run,
``defaults`` + ``train_mmnist_odecgru_len20_1ch`` read from
``configs.yaml`` (fp32, B=4, dopri5 'scan' with remat), on batches made on
the card as ``python -m ode_rl_torch.main`` makes them when ``data_dir``
holds no frozen corpus.

From the configuration's seed: 3 warm-up steps, 10 unprofiled steps timed
on the host clock (each closed by ``torch.cuda.synchronize()``), then
``torch.profiler`` over 3 more. Prints nvidia-smi's name and power limit,
the unprofiled step times and their median (with the mean NFE of those
steps for the flagship), the peak memory, the device kernel time per step,
over the profiled steps' own wall time (a floor of the busy share: the
profiler slows the host) and over the unprofiled median, device time by
group, the launches and device time a launch of each K1-K8 kernel found
(each of a kernel's variants by name), and the largest kernels. TF32 is off for
matmul and cuDNN, as in ``chip_smoke.py``, so an fp32 configuration runs
its convs in strict fp32.
"""

from __future__ import annotations

import argparse
import collections
import re
import statistics
import subprocess
import time

import torch

from ode_rl_torch.config import (FlagshipConfig, FlowNet2Config,
                                 FlowNetCBenchConfig)
from ode_rl_torch.core.config import load_config
from ode_rl_torch.data.sprites import get_sprite_bank
from ode_rl_torch.flow.flownets import FlowNet2, FlowNetC
from ode_rl_torch.flow.train import make_fused_flow_train_step
from ode_rl_torch.ops import common
from ode_rl_torch.train.step import create_train_state, make_fused_train_step

WARMUP, TIMED, PROFILED = 3, 10, 3

# The hand-written kernels by name, and the id of the TPU kernel each
# replaces (PERF.md §6).
_KERNEL_IDS = {
    "conv3x3_fwd_tc": "K1", "conv3x3_fwd_simt": "K1",
    "conv3x3_wgrad_tc": "K2", "conv3x3_wgrad_simt": "K2",
    "gru_gates_sample": "K3", "gru_gates": "K3",
    "gru_blend_sample": "K4", "gru_blend": "K4",
    "gru_gates_mom": "K3", "gru_gates_mom_vec": "K3", "gru_blend_mom": "K4",
    "gru_blend_mom_vec": "K4", "gru_moments": "K3/K4",
    "gru_moments_vec": "K3/K4",
    "corr_fwd_tc": "K5", "corr_fwd": "K5",
    "corr_bwd_f1_tc": "K6", "corr_bwd_f1": "K6",
    "corr_bwd_f2_tc": "K7", "corr_bwd_f2": "K7",
    "channelnorm": "K8",
}
_KERNEL_NAME = re.compile(r"\b(" + "|".join(_KERNEL_IDS)
                          + r")_kernel(<[^>]*>)?")

# Device kernels by substring of their names, first match wins.
_GROUPS = (
    ("K1 conv3x3_fwd, tensor cores", ("conv3x3_fwd_tc",)),
    ("K1 conv3x3_fwd, SIMT", ("conv3x3_fwd",)),
    ("K2 conv3x3_wgrad", ("conv3x3_wgrad",)),
    ("K3/K4 moments pass", ("gru_moments",)),
    ("K3 gru_gates", ("gru_gates",)),
    ("K4 gru_blend", ("gru_blend",)),
    ("K5-K7 correlation, tensor cores",
     ("corr_fwd_tc", "corr_bwd_f1_tc", "corr_bwd_f2_tc")),
    ("K5-K7 correlation, SIMT", ("corr_",)),
    ("K8 channelnorm", ("channelnorm",)),
    ("cuDNN conv (fprop, dgrad, wgrad)",
     ("conv", "xmma", "cudnn", "implicit", "gemm", "wgrad", "dgrad",
      "cutlass", "sm90")),
    ("Adam", ("adam", "foreach", "multi_tensor")),
    ("resize", ("upsample", "interp")),
    ("warp (grid_sample)", ("grid_sampler",)),
)


def _group(kernel: str) -> str:
    name = kernel.lower()
    for group, keys in _GROUPS:
        if any(k in name for k in keys):
            return group
    return "elementwise, reductions, copies"


def _step(net: str):
    """(configuration, a function running one step and returning its
    metrics) from the configuration's seed."""
    if net in ("flagship", "recipe"):
        cfg = (FlagshipConfig() if net == "flagship" else load_config(
            ("defaults", "train_mmnist_odecgru_len20_1ch")))
        bank = torch.from_numpy(get_sprite_bank(cfg.data_dir)).float().cuda()
        state = create_train_state(cfg, torch.device("cuda"))
        step = make_fused_train_step(cfg, bank)
        gen = torch.Generator(device="cuda").manual_seed(cfg.seed + 1)
        return cfg, lambda: step(state, gen)
    bank = torch.from_numpy(get_sprite_bank()).float().cuda()
    if net == "C":
        cfg = FlowNetCBenchConfig()
        model = FlowNetC(cfg.max_displacement, cfg.corr_stride,
                         dtype=getattr(torch, cfg.dtype),
                         generator=torch.Generator().manual_seed(cfg.seed))
    else:
        cfg = FlowNet2Config()
        model = FlowNet2(cfg.rgb_max, dtype=getattr(torch, cfg.dtype),
                         generator=torch.Generator().manual_seed(cfg.seed))
    init_fn, step_fn = make_fused_flow_train_step(
        model.cuda(), bank, batch=cfg.batch, lr=cfg.lr,
        loss_norm=cfg.loss_norm, single_scale=cfg.single_scale)
    state = init_fn()
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed + 1)
    return cfg, lambda: step_fn(state, gen)


def profile_step(net: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    cfg, step = _step(net)
    print(cfg)
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    times, nfes = [], []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        metrics = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if "nfe" in metrics:
            nfes.append(int(metrics["nfe"]))
    median = statistics.median(times)
    print(f"unprofiled step_ms over {TIMED} steps: {times}; median {median}")
    if nfes:
        print(f"nfe over those steps: {nfes}; mean {statistics.mean(nfes)}")

    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    print(f"peak memory GiB {torch.cuda.max_memory_allocated() / 2**30}")
    # Device kernels only: annotations such as "Optimizer.step#Adam.step"
    # also show as CUDA events, and they span kernels.
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and not e.key.startswith(("Optimizer.", "ProfilerStep"))]
    total = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profiled: {PROFILED} steps, wall {wall} ms, device kernel time "
          f"{total} ms; busy share {100 * total / wall}%; device ms per step "
          f"{total / PROFILED} ({100 * total / PROFILED / median}% of the "
          f"unprofiled median)")
    groups = collections.Counter()
    for e in events:
        groups[_group(e.key)] += e.self_device_time_total / 1e3
    for group, ms in groups.most_common():
        print(f"  {group:<34} {ms:10.3f} ms {100 * ms / total:5.1f}%")
    for e in sorted(events, key=lambda e: e.key):
        found = _KERNEL_NAME.search(e.key)
        if found:
            print(f"  {_KERNEL_IDS[found.group(1)]} {found.group(0)}: "
                  f"{e.count} launches, {e.self_device_time_total / e.count}"
                  f" us a launch")
    print(f"largest kernels over the {PROFILED} profiled steps:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x "
              f"{e.key[:100]}")
    print(f"launches in the profiled steps: {dict(common.launches)}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--net", choices=["flagship", "recipe", "C", "2"],
                        default="flagship")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    profile_step(args.net)


if __name__ == "__main__":
    main()
