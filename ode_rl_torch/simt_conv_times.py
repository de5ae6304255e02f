"""The SIMT K1 and K2 timed beside cuDNN at the shapes the port runs them.

    python -m ode_rl_torch.simt_conv_times [--label NAME] [--sweep]

Shapes (B, H, W, Cin) -> Cout: fp32 (4, 16, 16, 64) -> 64, the recipe's
field conv; fp32 (8, 16, 16, 64), chip_smoke.py phase 5's; fp32
(128, 16, 16, 64), the flagship batch; bf16 (128, 16, 16, 8) -> 64, which
both tensor-core rules refuse; fp32 (4, 32, 32, 128) -> 64, (4, 32, 32,
64) -> 64 and -> 128, the Vid-ODE field's convs at mgif's and penn's
128x128 frames; the same three at (4, 16, 16), its 64x64 blocks; fp32
(16, 16, 16, 32) -> 32, the slots'; fp32 (4, 4, 4, 32) -> 64 and (4, 4,
4, 128) -> 64, S3VAE's 'odecgru' field. For each: K1's SIMT kernel
forward and as dx (the cotangent with flip_transpose'd weights), K2's
SIMT kernel, and cuDNN's conv and weight gradient on the same inputs,
with TF32 off. Each gets the CUDA-event median ms of 30 calls and the
device µs a call under torch.profiler (every kernel the call launches),
in the turns a, b, ..., ..., b, a; the least of the two medians is kept.
The bound is the larger of the products over 67 TFLOP/s (fp32) or 989
TFLOP/s (bf16) and the bytes (inputs once, output once) over 3.35 TB/s.

The port is reached only through ``_conv3x3_fwd_simt`` and
``_conv3x3_wgrad_simt``, so this file copied into an older checkout's
``ode_rl_torch/`` times that checkout's SIMT kernels: run both checkouts
in one call, in turns, to compare them. Prints nvidia-smi's name and
power limit, a line a row, and one JSON line.

``--sweep`` (this checkout only) times instead the SIMT kernels' launch
plans around the ones ``simt_plan`` and ``wgrad_simt_plan`` pick: K1 at
16 and 32 output channels a block and 1 to 32 row steps a block, K2 at
tiles of 64 x 64, 128 x 64 and 64 x 128 and splits that put about a
half, one, one and a half and two blocks on each SM, device µs a call,
the plan's own marked with a star.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch
import torch.nn.functional as F

from ode_rl_torch.ops.conv3x3 import (_conv3x3_fwd_simt, _conv3x3_wgrad_simt,
                                      flip_transpose)

# (dtype, B, H = W, Cin, Cout), and the plans --sweep tries.
SWEEP = ((torch.float32, 4, 16, 64, 64), (torch.float32, 8, 16, 64, 64),
         (torch.float32, 128, 16, 64, 64),
         (torch.bfloat16, 128, 16, 8, 64),
         (torch.float32, 4, 32, 128, 64), (torch.float32, 4, 32, 64, 64),
         (torch.float32, 4, 32, 64, 128), (torch.float32, 4, 16, 128, 64),
         (torch.float32, 4, 16, 64, 128), (torch.float32, 16, 16, 32, 32),
         (torch.float32, 4, 4, 32, 64), (torch.float32, 4, 4, 128, 64))
SWEEP_K1_ROWS = (1, 2, 4, 8, 16, 32)
SWEEP_K2_BLOCKS_PER_SM = (0.5, 1, 1.5, 2)

SHAPES = ((torch.float32, 4, 16, 16, 64, 64),
          (torch.float32, 8, 16, 16, 64, 64),
          (torch.float32, 128, 16, 16, 64, 64),
          (torch.bfloat16, 128, 16, 16, 8, 64),
          (torch.float32, 4, 32, 32, 128, 64),
          (torch.float32, 4, 32, 32, 64, 64),
          (torch.float32, 4, 32, 32, 64, 128),
          (torch.float32, 4, 16, 16, 128, 64),
          (torch.float32, 4, 16, 16, 64, 64),
          (torch.float32, 4, 16, 16, 64, 128),
          (torch.float32, 16, 16, 16, 32, 32),
          (torch.float32, 4, 4, 4, 32, 64),
          (torch.float32, 4, 4, 4, 128, 64))
PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12


def median_ms(fn, reps: int = 30) -> float:
    for _ in range(3):
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


def device_us(fn, reps: int = 20, tries: int = 3) -> float:
    """Device µs a call under torch.profiler; a trace that lost its events
    (it reads 0 at times) is taken again."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type.name == "CUDA") / reps
        if us > 0:
            return us
    raise RuntimeError("the profiler recorded no device time")


def _calls(dtype, b, h, w, cin, cout) -> dict:
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)

    x, g = rnd(b, h, w, cin), rnd(b, h, w, cout)
    w2d = rnd(9 * cin, cout, scale=(9 * cin) ** -0.5)
    w_t = flip_transpose(w2d, cin, cout)
    w_oihw = w2d.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    return {
        "K1 SIMT": lambda: _conv3x3_fwd_simt(x, w2d),
        "K1 SIMT as dx": lambda: _conv3x3_fwd_simt(g, w_t),
        "K2 SIMT": lambda: _conv3x3_wgrad_simt(x, g),
        "cuDNN conv": lambda: F.conv2d(x.permute(0, 3, 1, 2), w_oihw,
                                       padding=1),
        "cuDNN wgrad": lambda: torch.ops.aten.convolution_backward(
            g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w_oihw, None,
            [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [False, True, False])[1],
    }


def sweep() -> None:
    """Device µs a call of the SIMT kernels at other launch plans than
    their plan functions pick, through the library's entry points."""
    from ode_rl_torch.ops import common
    from ode_rl_torch.ops._build import library
    from ode_rl_torch.ops.conv3x3 import (_sm_count, simt_plan,
                                          wgrad_simt_plan)
    lib = library()
    sms = _sm_count(torch.device("cuda"))
    gen = torch.Generator().manual_seed(0)
    for dtype, b, hw, cin, cout in SWEEP:
        x = torch.randn(b, hw, hw, cin, generator=gen).to("cuda", dtype)
        g = torch.randn(b, hw, hw, cout, generator=gen).to("cuda", dtype)
        w2d = (torch.randn(9 * cin, cout, generator=gen) / 24).to("cuda",
                                                                  dtype)
        out = torch.empty(b, hw, hw, cout, dtype=dtype, device="cuda")
        mine = simt_plan(b, hw, hw, cin, cout, sms)[:2]
        line = []
        for bn in (16, 32):
            for rows in SWEEP_K1_ROWS:
                def call(bn=bn, rows=rows):
                    common.launch("conv3x3_fwd_simt", lib.odek_conv3x3_fwd,
                                  x.data_ptr(), None, w2d.data_ptr(),
                                  out.data_ptr(), b, hw, hw, cin, cout, bn,
                                  rows, common.DTYPE_CODES[dtype],
                                  common.stream_handle(x))
                star = "*" if (bn, rows) == mine else ""
                line.append(f"BN {bn} R {rows}{star}: {device_us(call):.2f}")
        print(f"sweep K1 {str(dtype)[6:]} ({b}, {hw}, {hw}, {cin}) -> "
              f"{cout}: " + ", ".join(line))
        dw = torch.empty(9 * cin, cout, device="cuda")
        mine = wgrad_simt_plan(b, hw, hw, cin, cout, sms)
        stages = -(-(b * hw * hw) // 16)
        line = []
        for kt, nt in ((64, 64), (128, 64), (64, 128)):
            tiles = -(-(9 * cin) // kt) * -(-cout // nt)
            seen = set()
            for per_sm in SWEEP_K2_BLOCKS_PER_SM:
                cap = max(1, min(stages, int(per_sm * sms) // tiles))
                per = -(-stages // cap)
                plan = (kt, nt, -(-stages // per), 16 * per)
                if plan in seen:
                    continue
                seen.add(plan)
                scratch = torch.empty(plan[2], 9 * cin, cout, device="cuda")

                def call(plan=plan, scratch=scratch):
                    common.launch("conv3x3_wgrad_simt",
                                  lib.odek_conv3x3_wgrad, x.data_ptr(), None,
                                  g.data_ptr(), scratch.data_ptr(),
                                  dw.data_ptr(), b, hw, hw, cin, cout,
                                  *plan, common.DTYPE_CODES[dtype],
                                  common.stream_handle(x))
                star = "*" if plan == mine else ""
                line.append(f"{kt}x{nt} S {plan[2]} P {plan[3]}{star}: "
                            f"{device_us(call):.2f}")
        print(f"sweep K2 {str(dtype)[6:]} ({b}, {hw}, {hw}, {cin}) -> "
              f"{cout}: " + ", ".join(line))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--sweep", action="store_true",
                        help="time other launch plans of this checkout's "
                             "SIMT kernels instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    if args.sweep:
        sweep()
        return
    rows = []
    for dtype, b, h, w, cin, cout in SHAPES:
        calls = _calls(dtype, b, h, w, cin, cout)
        ms = {}
        for label in [*calls, *reversed(calls)]:
            ms.setdefault(label, []).append(median_ms(calls[label]))
        size = torch.finfo(dtype).bits // 8
        px = b * h * w
        ops = 2 * px * 9 * cin * cout
        io = {"K1": (px * (cin + cout) + 9 * cin * cout) * size,
              "K2": px * (cin + cout) * size + 9 * cin * cout * 4}
        for label, fn in calls.items():
            kind = "K2" if "wgrad" in label or label.startswith("K2") else "K1"
            bound = max(ops / PEAK[dtype], io[kind] / PEAK_BYTES) * 1e6
            row = {"label": args.label, "dtype": str(dtype)[6:],
                   "shape": [b, h, w, cin, cout], "call": label,
                   "ms": min(ms[label]), "device_us": device_us(fn),
                   "bound_us": bound}
            rows.append(row)
            print(f"{args.label}: {row['dtype']} {tuple(row['shape'])} "
                  f"{label}: median ms {row['ms']:.4f}, device us "
                  f"{row['device_us']:.2f}, bound us {bound:.2f}")
    print(json.dumps({"label": args.label,
                      "device": torch.cuda.get_device_name(0),
                      "rows": rows}))


if __name__ == "__main__":
    main()
