"""Where a fused FlowNet training step spends its time on one card.

    python -m ode_rl_torch.flow.profile_step --net C   # FlowNetCBenchConfig
    python -m ode_rl_torch.flow.profile_step --net 2   # FlowNet2Config

From the configuration's seed: 3 warm-up steps, 10 unprofiled steps timed
on the host clock (each closed by ``torch.cuda.synchronize()``), then
``torch.profiler`` over 3 more. Prints nvidia-smi's name and power limit,
the unprofiled step times and their median, the peak memory, the device
kernel time per step, over the profiled steps' own wall time (a floor of
the busy share: the profiler slows the host) and over the unprofiled
median, device time by group and the largest kernels. TF32 is off for
matmul and cuDNN, as in ``chip_smoke.py``, so an fp32 configuration runs
its convs in strict fp32.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import subprocess
import time

import torch

from ode_rl_torch.config import FlowNet2Config, FlowNetCBenchConfig
from ode_rl_torch.data.sprites import get_sprite_bank
from ode_rl_torch.flow.flownets import FlowNet2, FlowNetC
from ode_rl_torch.flow.train import make_fused_flow_train_step
from ode_rl_torch.ops import common

WARMUP, TIMED, PROFILED = 3, 10, 3

# Device kernels by substring of their names, first match wins.
_GROUPS = (
    ("K5-K7 correlation", ("corr_",)),
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


def _model(net: str):
    if net == "C":
        cfg = FlowNetCBenchConfig()
        model = FlowNetC(cfg.max_displacement, cfg.corr_stride,
                         dtype=getattr(torch, cfg.dtype),
                         generator=torch.Generator().manual_seed(cfg.seed))
    else:
        cfg = FlowNet2Config()
        model = FlowNet2(cfg.rgb_max, dtype=getattr(torch, cfg.dtype),
                         generator=torch.Generator().manual_seed(cfg.seed))
    return cfg, model.cuda()


def profile_step(net: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    cfg, model = _model(net)
    print(f"{type(model).__name__}: {cfg}")
    bank = torch.from_numpy(get_sprite_bank()).float().cuda()
    init_fn, step_fn = make_fused_flow_train_step(
        model, bank, batch=cfg.batch, lr=cfg.lr, loss_norm=cfg.loss_norm,
        single_scale=cfg.single_scale)
    state = init_fn()
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed + 1)
    for _ in range(WARMUP):
        step_fn(state, gen)
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        step_fn(state, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(times)
    print(f"unprofiled step_ms over {TIMED} steps: {times}; median {median}")

    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            step_fn(state, gen)
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
    print(f"largest kernels over the {PROFILED} profiled steps:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x "
              f"{e.key[:100]}")
    print(f"launches in the profiled steps: {dict(common.launches)}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--net", choices=["C", "2"], default="C")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    profile_step(args.net)


if __name__ == "__main__":
    main()
