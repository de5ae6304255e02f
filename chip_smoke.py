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
   plain versions; then K5-K7 (correlation forward and its two gradients)
   at the FlowNetC bench shape (features (256, 8, 8, 256), d=20, stride 2)
   and the FlyingChairs feature shape (8, 48, 64, 256), and K8
   (channelnorm) at FlowNet2's (8, 64, 64, 3) and (8, 64, 64, 2), in fp32
   and bf16 (bf16 K6-K8 bit-equal to their plain versions, K5 to 1e-4
   relative L2), with CorrelationFn's and ChannelNormFn's gradients
   against fp64; prints each error beside its tolerance and the median
   time of each kernel and its plain version (CUDA events);
4. slice: ten fused training steps of the flagship configuration (bf16,
   B=128, 10 -> 10 frames, dopri5 'fast') from the port's own init, seed 0;
   every loss and grad_norm finite, and every kernel's launch count above
   zero over these steps;
5. reference: one fp32 step at B=8 through the kernels against the same
   step on the plain versions (same weights, same batch): equal NFE and
   accepted/rejected counts, loss to 1e-5 relative, every gradient leaf to
   1e-3 relative L2;
6. FlowNetC: ten fused training steps of FlowNetCBenchConfig (bf16,
   B=256, synthetic chairs made on the card, multiscale L1), seed 0; every
   loss, EPE and grad_norm finite, and K5-K7 launched in these steps;
7. FlowNet2: three single-scale L1 steps of the stacked FlowNet2
   (FlowNet2Config, fp32, B=8); finite, and K5-K8 launched in these steps;
8. FlowNet reference: one fp32 FlowNetC step at B=8 through the kernels
   against the same step on the plain versions: loss to 1e-5 relative,
   every gradient leaf to 1e-3 relative L2.

TF32 is off for matmul and cuDNN throughout, so the fp32 steps (phases 5,
7 and 8) run their convs in strict fp32. Then one JSON line with each
kernel's launches, error and times, and as the last line {"ok": true,
"device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

from ode_rl_torch.config import (FlagshipConfig, FlowNet2Config,
                                 FlowNetCBenchConfig)
from ode_rl_torch.data.mmnist import generate_moving_mnist
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.data.sprites import get_sprite_bank
from ode_rl_torch.flow.flownets import FlowNet2, FlowNetC
from ode_rl_torch.flow.train import (flow_loss_and_grads,
                                     make_fused_flow_train_step,
                                     synthetic_flow_batch)
from ode_rl_torch.ops import _build, common
from ode_rl_torch.ops.channelnorm import (ChannelNormFn, channelnorm_fwd,
                                          channelnorm_plain)
from ode_rl_torch.ops.conv3x3 import (Conv3x3Fn, conv3x3_fwd,
                                      conv3x3_fwd_plain, conv3x3_wgrad,
                                      flip_transpose)
from ode_rl_torch.ops.correlation import (CorrelationFn, correlation_bwd_f1,
                                          correlation_bwd_f2,
                                          correlation_fwd,
                                          correlation_fwd_plain)
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
    "correlation_fwd": ("ode_rl_torch/csrc/correlation.cu",
                        "ode_rl_tpu/ops/correlation.py:64"),
    "correlation_bwd_f1": ("ode_rl_torch/csrc/correlation.cu",
                           "ode_rl_tpu/ops/correlation.py:116"),
    "correlation_bwd_f2": ("ode_rl_torch/csrc/correlation.cu",
                           "ode_rl_tpu/ops/correlation.py:136"),
    "channelnorm": ("ode_rl_torch/csrc/channelnorm.cu",
                    "ode_rl_tpu/ops/channelnorm.py:30"),
}
FLAGSHIP_KERNELS = ("conv3x3_fwd", "conv3x3_wgrad", "gru_gates", "gru_blend")
FLOWNETC_KERNELS = ("correlation_fwd", "correlation_bwd_f1",
                    "correlation_bwd_f2")
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
    results.update(_check_flow_kernels(gen))
    return results


# FlowNetC bench features, FlyingChairs features, correlation geometry.
CORR_SHAPES = {"bench": (256, 8, 8, 256), "chairs": (8, 48, 64, 256)}
CORR_D, CORR_STRIDE = 20, 2
NORM_SHAPES = ((8, 64, 64, 3), (8, 64, 64, 2))


def _flow_tol(name: str, dtype) -> tuple:
    """(tolerance, metric) of K5-K8 against their plain versions.

    fp32: the kernel and the plain version sum the same fp32 products in
    another order. bf16: a product of two bf16 values is exact in fp32.
    K6, K7 and K8 (C <= 3) add those products in the same order as their
    plain versions, divide and take the square root as IEEE does, and round
    once to nearest, so they are bit-equal. K5 sums its C products in
    another order than the plain mean, so the two round differently where
    their fp32 sums straddle a bf16 rounding boundary: 1e-4 relative L2. A
    kernel that truncated, or rounded its accumulator partway, would read
    about 2e-3."""
    if dtype == torch.float32:
        return 1e-5, "max_abs"
    if name == "correlation_fwd":
        return 1e-4, "rel_l2"
    return 0.0, "max_abs"


def _flow_ops(shape, dtype, gen):
    def rnd(*s):
        return torch.randn(*s, generator=gen).to("cuda", dtype)
    b, h, w, c = shape
    f1, f2, g = rnd(b, h, w, c), rnd(b, h, w, c), rnd(b, h, w, 441)
    return {
        "correlation_fwd": lambda: correlation_fwd(f1, f2, CORR_D,
                                                   CORR_STRIDE),
        "correlation_bwd_f1": lambda: correlation_bwd_f1(g, f2, CORR_D,
                                                         CORR_STRIDE),
        "correlation_bwd_f2": lambda: correlation_bwd_f2(g, f1, CORR_D,
                                                         CORR_STRIDE),
    }


def _check_flow_kernels(gen) -> dict:
    """K5-K8 against their plain versions; returns the bf16 bench-shape
    (K5-K7) and fp32 FlowNet2-shape (K8) errors and median times."""
    print("  FlowNet kernels vs plain versions (d=20, stride 2):")
    results = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for label, shape in CORR_SHAPES.items():
                for name, fn in _flow_ops(shape, dtype, gen).items():
                    out = fn()
                    with common.force_plain():
                        ref = fn()
                    tol, kind = _flow_tol(name, dtype)
                    metric = max_abs if kind == "max_abs" else rel_l2
                    check(f"{name} {label} {str(dtype)[6:]}",
                          metric(out, ref), tol, kind)
                    if dtype == torch.bfloat16:
                        ms = median_ms(fn)
                        with common.force_plain():
                            plain_ms = median_ms(fn)
                        print(f"    {name} {label} bf16 median ms: kernel "
                              f"{ms:.4f} plain {plain_ms:.4f}")
                        if label == "bench":
                            results[name] = {"max_abs_err": max_abs(out, ref),
                                             "ms": ms, "plain_ms": plain_ms}
            for shape in NORM_SHAPES:
                x = torch.randn(*shape, generator=gen).to("cuda", dtype)
                x[0, :4] = 0.0
                out = channelnorm_fwd(x)
                ref = channelnorm_plain(x)
                tol, kind = _flow_tol("channelnorm", dtype)
                metric = max_abs if kind == "max_abs" else rel_l2
                check(f"channelnorm {shape[-1]}ch {str(dtype)[6:]}",
                      metric(out, ref), tol, kind)
                if dtype == torch.float32 and shape[-1] == 3:
                    ms = median_ms(lambda: channelnorm_fwd(x))
                    plain_ms = median_ms(lambda: channelnorm_plain(x))
                    print(f"    channelnorm (8, 64, 64, 3) fp32 median ms: "
                          f"kernel {ms:.4f} plain {plain_ms:.4f}")
                    results["channelnorm"] = {
                        "max_abs_err": max_abs(out, ref), "ms": ms,
                        "plain_ms": plain_ms}
    _check_flow_gradients(gen)
    return results


def _check_flow_gradients(gen) -> None:
    print("  CorrelationFn and ChannelNormFn gradients (fp32) vs autograd "
          "of the fp64 plain versions:")
    for label, shape in CORR_SHAPES.items():
        f1, f2, g = (torch.randn(*s, generator=gen).cuda()
                     for s in (shape, shape, (*shape[:3], 441)))

        def grads(fn, dtype):
            leaves = [t.to(dtype).requires_grad_(True) for t in (f1, f2)]
            return torch.autograd.grad(fn(*leaves, CORR_D, CORR_STRIDE),
                                       leaves, g.to(dtype))

        k = grads(CorrelationFn.apply, torch.float32)
        p = grads(correlation_fwd_plain, torch.float64)
        check(f"CorrelationFn df1 {label}", max_abs(k[0], p[0]), 1e-5,
              "max_abs")
        check(f"CorrelationFn df2 {label}", max_abs(k[1], p[1]), 1e-5,
              "max_abs")
    x = torch.randn(*NORM_SHAPES[0], generator=gen).cuda()
    x[0, :4] = 0.0
    g = torch.randn(*NORM_SHAPES[0][:3], 1, generator=gen).cuda()
    leaf = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(ChannelNormFn.apply(leaf), leaf, g)
    x64 = x.double()
    norm = x64.norm(dim=-1, keepdim=True)
    expect = torch.where(norm > 0, x64 * g.double() / norm.clamp_min(1e-12),
                         torch.zeros_like(x64))
    check("ChannelNormFn dx vs fp64", max_abs(gx, expect), 1e-6, "max_abs")
    if not torch.equal(gx[0, :4], torch.zeros_like(gx[0, :4])):
        raise AssertionError("ChannelNormFn: gradient at zero norm is not 0")


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
    missing = [k for k in FLAGSHIP_KERNELS if counts[k] == 0]
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


def _run_flow_steps(label: str, model, cfg, bank, n_steps: int,
                    expected: tuple) -> tuple:
    """n fused training steps from seed 1 with the launch counts reset
    just before; returns (counts, median step_ms over steps 1..n-1)."""
    init_fn, step_fn = make_fused_flow_train_step(
        model, bank, batch=cfg.batch, lr=cfg.lr, loss_norm=cfg.loss_norm,
        single_scale=cfg.single_scale)
    state = init_fn()
    gen = torch.Generator(device="cuda").manual_seed(1)
    step_ms = []
    torch.cuda.synchronize()
    common.reset_launches()
    for i in range(n_steps):
        t0 = time.perf_counter()
        m = step_fn(state, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"  step {i}: loss {float(m['loss']):.6f} epe "
              f"{float(m['epe']):.6f} grad_norm {float(m['grad_norm']):.6f} "
              f"step_ms {step_ms[-1]:.2f}")
        if not all(torch.isfinite(v) for v in m.values()):
            raise AssertionError(f"{label} step {i}: a metric is not finite")
    counts = dict(common.launches)
    print(f"  launches over the {n_steps} steps: {counts}")
    missing = [k for k in expected if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {label} path: "
                             f"{missing}")
    median = statistics.median(step_ms[1:])
    print(f"  median step_ms over steps 1-{n_steps - 1}: {median:.2f}")
    return counts, median


def phase_flownetc(bank: torch.Tensor) -> dict:
    cfg = FlowNetCBenchConfig()
    print(f"[6] FlowNetC: 10 fused training steps, B={cfg.batch}, "
          f"{cfg.dtype}, 64x64, d={cfg.max_displacement}, "
          f"stride {cfg.corr_stride}, seed {cfg.seed}")
    model = FlowNetC(cfg.max_displacement, cfg.corr_stride,
                     dtype=getattr(torch, cfg.dtype),
                     generator=torch.Generator().manual_seed(cfg.seed))
    counts, _ = _run_flow_steps("FlowNetC", model.cuda(), cfg, bank, 10,
                                FLOWNETC_KERNELS)
    return counts


def phase_flownet2(bank: torch.Tensor) -> dict:
    cfg = FlowNet2Config()
    model = FlowNet2(cfg.rgb_max, dtype=getattr(torch, cfg.dtype),
                     generator=torch.Generator().manual_seed(cfg.seed))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[7] FlowNet2: 3 single-scale {cfg.loss_norm} steps, "
          f"B={cfg.batch}, {cfg.dtype}, {n_params:,} parameters")
    counts, _ = _run_flow_steps("FlowNet2", model.cuda(), cfg, bank, 3,
                                (*FLOWNETC_KERNELS, "channelnorm"))
    return counts


def phase_flow_reference(bank: torch.Tensor) -> None:
    print("[8] FlowNetC fp32 step at B=8: kernels vs plain versions, same "
          "weights and batch")
    model = FlowNetC(generator=torch.Generator().manual_seed(0)).cuda()
    img1, img2, flow = synthetic_flow_batch(
        torch.Generator(device="cuda").manual_seed(2), bank, batch=8)

    def run():
        metrics = flow_loss_and_grads(model, (img1, img2), flow)
        return metrics, {n: p.grad.clone()
                         for n, p in model.named_parameters()}

    m_k, g_k = run()
    with common.force_plain():
        m_p, g_p = run()
    for key in ("loss", "epe"):
        check(f"{key} (relative)", abs(float(m_k[key]) / float(m_p[key])
                                       - 1.0), 1e-5, "rel")
    worst = max(g_k, key=lambda n: rel_l2(g_k[n], g_p[n]))
    check(f"worst grad leaf ({worst})", rel_l2(g_k[worst], g_p[worst]), 1e-3,
          "rel_l2")


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = phase_device()
    build_s = phase_build()
    timings = phase_kernels()
    bank = torch.from_numpy(
        get_sprite_bank(FlagshipConfig().data_dir)).float().cuda()
    counts = {k: v for k, v in phase_slice(bank).items()
              if k in FLAGSHIP_KERNELS}
    phase_reference(bank)
    counts.update({k: v for k, v in phase_flownetc(bank).items()
                   if k in FLOWNETC_KERNELS})
    counts["channelnorm"] = phase_flownet2(bank)["channelnorm"]
    phase_flow_reference(bank)
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
