#!/usr/bin/env python3
"""Build the PyTorch port's kernels and drive its main path on one H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing its last line:

1. device: a CUDA card of compute capability 9.0; prints nvidia-smi's
   name and power limit;
2. build: compiles ode_rl_torch/csrc with nvcc into build/ode_rl_torch/
   and loads it; prints the build seconds and ptxas' register use;
3. kernels: K1 (forward and as dx), K2, K3 and K4 against their plain
   PyTorch versions at the flagship shapes (B=128), in fp32 and bf16, with
   TF32 off, and the autograd Functions' gradients against autograd of the
   plain versions; prints each error beside its tolerance and the median
   time of each kernel and its plain version (CUDA events);
4. slice: ten fused training steps of the flagship configuration (bf16,
   B=128, 10 -> 10 frames, dopri5 'fast') from the port's own init, seed 0;
   every loss and grad_norm finite, and every kernel's launch count above
   zero over these steps;
5. reference: one fp32 step at B=8 through the kernels against the same
   step on the plain versions (same weights, same batch): equal NFE and
   accepted/rejected counts, loss to 1e-5 relative, every gradient leaf to
   1e-3 relative L2.

Then one JSON line with each kernel's launches, error and times, and as
the last line {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

from ode_rl_torch.config import FlagshipConfig
from ode_rl_torch.data.mmnist import generate_moving_mnist
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.data.sprites import get_sprite_bank
from ode_rl_torch.ops import _build, common
from ode_rl_torch.ops.conv3x3 import (Conv3x3Fn, conv3x3_fwd,
                                      conv3x3_fwd_plain, conv3x3_wgrad,
                                      flip_transpose)
from ode_rl_torch.ops.gru_gates import (_blend_plain, _gates_plain,
                                        fused_gru_blend, fused_gru_gates)
from ode_rl_torch.train.step import (create_train_state, loss_and_grads,
                                     make_fused_train_step)

KERNELS = {
    "conv3x3_fwd": ("ode_rl_torch/csrc/conv3x3.cu",
                    "ode_rl_tpu/ops/conv3x3.py:84"),
    "conv3x3_wgrad": ("ode_rl_torch/csrc/conv3x3.cu",
                      "ode_rl_tpu/ops/conv3x3.py:96"),
    "gru_gates": ("ode_rl_torch/csrc/gru_gates.cu",
                  "ode_rl_tpu/ops/gru_gates.py:103"),
    "gru_blend": ("ode_rl_torch/csrc/gru_gates.cu",
                  "ode_rl_tpu/ops/gru_gates.py:184"),
}
# Flagship shapes: the field state (B, 16, 16, 64); gates 2C = 128 in 4
# groups, candidate C = 64 in 2 groups.
B, HW, C = 128, 16, 64


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm()
            / b.float().norm().clamp_min(1e-30)).item()


def check(label: str, err: float, tol: float, kind: str) -> float:
    ok = err <= tol
    print(f"  {label:<34} {kind} {err:.3e} (tolerance {tol:.1e}) "
          f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{label}: {kind} {err} > {tol}")
    return err


def median_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need an H100")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"{torch.cuda.get_device_name(0)} is sm_"
                           f"{cap[0]}{cap[1]}; the kernels are built for "
                           "sm_90a")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print("[1] device (nvidia-smi name, power.limit):")
    print(smi.strip().splitlines()[0])
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}")
    return torch.cuda.get_device_name(0)


def phase_build() -> float:
    t0 = time.perf_counter()
    log = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    print(f"[2] build: {seconds:.2f} s -> {_build.library_path()}")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("    " + line.strip())
    return seconds


def _inputs(dtype, gen):
    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)
    return dict(
        x=rnd(B, HW, HW, C), g=rnd(B, HW, HW, C),
        w2d=rnd(9 * C, C, scale=1.0 / 24.0),
        # The ConvGRU state is a convex blend of tanh values: |h| < 1.
        gates=rnd(B, HW, HW, 2 * C), h=torch.tanh(rnd(B, HW, HW, C)),
        cand=rnd(B, HW, HW, C), z=torch.sigmoid(rnd(B, HW, HW, C)),
        gs=(1.0 + 0.1 * torch.randn(2 * C, generator=gen)).cuda(),
        gb=(0.1 * torch.randn(2 * C, generator=gen)).cuda(),
        cs=(1.0 + 0.1 * torch.randn(C, generator=gen)).cuda(),
        cb=(0.1 * torch.randn(C, generator=gen)).cuda())


def _ops(t):
    w_t = flip_transpose(t["w2d"], C, C)
    return {
        "conv3x3_fwd": lambda: conv3x3_fwd(t["x"], t["w2d"]),
        "conv3x3_fwd as dx": lambda: conv3x3_fwd(t["g"], w_t),
        "conv3x3_wgrad": lambda: conv3x3_wgrad(t["x"], t["g"]),
        "gru_gates": lambda: fused_gru_gates(t["gates"], t["h"], t["gs"],
                                             t["gb"], 4),
        "gru_blend": lambda: fused_gru_blend(t["cand"], t["z"], t["h"],
                                             t["cs"], t["cb"], 2),
    }


# (fp32 tolerance, bf16 tolerance, metric): see README's port section.
_TOL = {
    "conv3x3_fwd": (1e-4, 1e-2), "conv3x3_fwd as dx": (1e-4, 1e-2),
    "conv3x3_wgrad": (1e-5, 1e-2), "gru_gates": (1e-5, 1 / 128),
    "gru_blend": (1e-5, 1 / 128),
}


def _metric(name: str, dtype) -> str:
    if name.startswith("gru"):
        return "max_abs"
    if name == "conv3x3_wgrad" or dtype == torch.bfloat16:
        return "rel_l2"
    return "max_abs"


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[3] kernels vs plain versions at B=128 (TF32 off for matmul and "
          "cuDNN)")
    gen = torch.Generator().manual_seed(0)
    results = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            print(f"  -- {dtype}")
            t = _inputs(dtype, gen)
            for name, fn in _ops(t).items():
                out = fn()
                with common.force_plain():
                    ref = fn()
                outs = out if isinstance(out, tuple) else (out,)
                refs = ref if isinstance(ref, tuple) else (ref,)
                kind = _metric(name, dtype)
                metric = max_abs if kind == "max_abs" else rel_l2
                tol = _TOL[name][dtype == torch.bfloat16]
                err = max(metric(o, r) for o, r in zip(outs, refs))
                check(f"{name} {str(dtype)[6:]}", err, tol, kind)
                if dtype == torch.bfloat16 and name in KERNELS:
                    results[name] = {"max_abs_err": max(
                        max_abs(o, r) for o, r in zip(outs, refs))}
                    results[name]["ms"] = median_ms(fn)
                    with common.force_plain():
                        results[name]["plain_ms"] = median_ms(fn)
    print("  median ms over 30 reps, bf16, B=128 (kernel / plain):")
    for name, r in results.items():
        print(f"    {name:<14} {r['ms']:.4f} / {r['plain_ms']:.4f}")
    _check_gradients(gen)
    return results


def _check_gradients(gen) -> None:
    print("  gradients of the autograd Functions (fp32) vs autograd of the "
          "plain versions:")
    t = _inputs(torch.float32, gen)

    def grads(fn, args, leaves, dtype=torch.float32):
        leaves = [a.detach().to(dtype).requires_grad_(True) for a in leaves]
        outs = fn(*leaves, *args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        total = sum((o * torch.linspace(-1, 1, o.numel(), device="cuda",
                                        dtype=dtype).reshape(o.shape)).sum()
                    for o in outs)
        return torch.autograd.grad(total, leaves)

    # The conv reference runs in fp64: dW sums 32,768 rows, and cuDNN's
    # fp32 order of summation alone drifts by about 1e-5 relative.
    conv_args = (t["x"], t["w2d"])
    k = grads(Conv3x3Fn.apply, (), conv_args)
    p = grads(conv3x3_fwd_plain, (), conv_args, torch.float64)
    p32 = grads(conv3x3_fwd_plain, (), conv_args)
    check("Conv3x3Fn dx vs fp64", max_abs(k[0], p[0]), 1e-4, "max_abs")
    check("Conv3x3Fn dw vs fp64", rel_l2(k[1], p[1]), 1e-5, "rel_l2")
    print(f"  (cuDNN fp32 vs fp64: dx max_abs {max_abs(p32[0], p[0]):.3e}, "
          f"dw rel_l2 {rel_l2(p32[1], p[1]):.3e})")
    gate_args = (t["gates"], t["h"], t["gs"], t["gb"])
    k = grads(fused_gru_gates, (4,), gate_args)
    p = grads(_gates_plain, (4,), gate_args)
    check("fused_gru_gates grads", max(max_abs(a, b) for a, b in zip(k, p)),
          1e-5, "max_abs")
    blend_args = (t["cand"], t["z"], t["h"], t["cs"], t["cb"])
    k = grads(fused_gru_blend, (2,), blend_args)
    p = grads(_blend_plain, (2,), blend_args)
    check("fused_gru_blend grads", max(max_abs(a, b) for a, b in zip(k, p)),
          1e-5, "max_abs")


def phase_slice(bank: torch.Tensor) -> dict:
    cfg = FlagshipConfig()
    print(f"[4] slice: 10 fused training steps, B={cfg.batch_size}, "
          f"{cfg.compute_dtype}, {cfg.train_in_seq}->{cfg.train_out_seq} "
          f"frames, dopri5 {cfg.ode_solver}, seed 0")
    state = create_train_state(cfg, torch.device("cuda"))
    step = make_fused_train_step(cfg, bank)
    gen = torch.Generator(device="cuda").manual_seed(1)
    step_ms, nfes = [], []
    torch.cuda.synchronize()
    common.reset_launches()
    for i in range(10):
        t0 = time.perf_counter()
        m = step(state, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        nfes.append(m["nfe"])
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        print(f"  step {i}: loss {loss:.6f} mse {float(m['mse']):.6f} "
              f"nfe {m['nfe']} accepted {m['ode_accepted']} rejected "
              f"{m['ode_rejected']} converged {m['ode_converged']} "
              f"grad_norm {gnorm:.6f} step_ms {step_ms[-1]:.2f}")
        if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
            raise AssertionError(f"step {i}: loss or grad_norm not finite")
    counts = dict(common.launches)
    print(f"  launches over the 10 steps: {counts}")
    missing = [k for k in KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    print(f"  median step_ms over steps 1-9: "
          f"{statistics.median(step_ms[1:]):.2f}; mean nfe "
          f"{statistics.mean(nfes):.1f}")
    return counts


def phase_reference(bank: torch.Tensor) -> None:
    cfg = dataclasses.replace(FlagshipConfig(), batch_size=8,
                              compute_dtype="float32")
    print("[5] fp32 step at B=8: kernels vs plain versions, same weights "
          "and batch")
    state = create_train_state(cfg, torch.device("cuda"))
    video = generate_moving_mnist(
        torch.Generator(device="cuda").manual_seed(2), bank, cfg.batch_size,
        cfg.train_in_seq + cfg.train_out_seq, cfg.num_digits)
    batch = make_batch_dict(video, cfg.train_in_seq)
    model = state.model

    def run():
        metrics, pred = loss_and_grads(model, batch)
        return metrics, pred, {n: p.grad.clone()
                               for n, p in model.named_parameters()}

    m_k, pred_k, g_k = run()
    with common.force_plain():
        m_p, pred_p, g_p = run()
    shape = (cfg.batch_size, cfg.train_out_seq, 64, 64, 1)
    if tuple(pred_k.shape) != shape or not torch.isfinite(pred_k).all():
        raise AssertionError(f"prediction {tuple(pred_k.shape)} is not a "
                             f"finite {shape}")
    for stat in ("nfe", "ode_accepted", "ode_rejected"):
        print(f"  {stat}: kernels {m_k[stat]} plain {m_p[stat]}")
        if m_k[stat] != m_p[stat]:
            raise AssertionError(f"{stat} differs")
    check("loss (relative)", abs(float(m_k["loss"]) / float(m_p["loss"])
                                 - 1.0), 1e-5, "rel")
    check("prediction", max_abs(pred_k, pred_p), 1e-4, "max_abs")
    worst = max(g_k, key=lambda n: rel_l2(g_k[n], g_p[n]))
    check(f"worst grad leaf ({worst})", rel_l2(g_k[worst], g_p[worst]), 1e-3,
          "rel_l2")


def main() -> int:
    kind = phase_device()
    build_s = phase_build()
    timings = phase_kernels()
    bank = torch.from_numpy(
        get_sprite_bank(FlagshipConfig().data_dir)).float().cuda()
    counts = phase_slice(bank)
    phase_reference(bank)
    print(f"build_s {build_s:.2f}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": tpu,
         "launches": counts[name], **timings[name]}
        for name, (source, tpu) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
