"""A sweep of the tensor-core K2's launch plan at 32 output channels a block.

    python -m ode_rl_torch.axis_conv_times

A 'model' rank's bf16 K2 at the flagship's width, (128, 16, 16, 64) x
(128, 16, 16, 32), and a Cout 96 conv (three blocks of 32 output
channels), through the library's entry point at several plans: the tiles
(8 x 16 pixels, 256 of them) in S splits of T tiles, and 2 to 6 TMA stages
a block. Each plan's device µs a call under torch.profiler (20 calls, the
cooperative launch and nothing else), the plan the wrapper takes
(``wgrad_tc_plan``'s splits, 4 stages) marked with a star. Every plan's
dW is held within 5e-6 relative L2 of the fp64 patches^T . g and
bit-equal over two calls, so a plan that computes something else cannot
win. Prints nvidia-smi's name and power limit, a line a shape, and one
JSON line.
"""

from __future__ import annotations

import json
import subprocess

import torch

# (B, H, W, Cin, Cout) and the tiles a split the sweep tries (S = the
# tiles over T, rounded up; 3 * pairs * S blocks at most one an SM).
SHAPES = (((128, 16, 16, 64, 32), (6, 8, 11, 12, 16, 22, 32)),
          ((128, 16, 16, 64, 96), (19, 22, 26, 32)))
STAGES = (2, 3, 4, 6)


def device_us(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / reps


def sweep() -> list:
    from ode_rl_torch.ops import common
    from ode_rl_torch.ops._build import library
    from ode_rl_torch.ops.conv3x3 import (_sm_count, conv3x3_wgrad_plain,
                                          wgrad_tc_nt, wgrad_tc_plan)
    lib = library()
    sms = _sm_count(torch.device("cuda"))
    gen = torch.Generator().manual_seed(0)
    rows = []
    for (b, h, w, cin, cout), pers in SHAPES:
        x = torch.randn(b, h, w, cin, generator=gen).to("cuda",
                                                        torch.bfloat16)
        g = torch.randn(b, h, w, cout, generator=gen).to("cuda",
                                                         torch.bfloat16)
        ref = conv3x3_wgrad_plain(x.double(), g.double())
        tw, _, mine_per = wgrad_tc_plan(b, h, w, cin, cout, sms)
        tiles = b * -(-h // 8) * -(-w // tw)
        pairs = (cin // 64) * (cout // wgrad_tc_nt(cout))
        line = []
        for per in sorted(set(pers) | {mine_per}):
            splits = -(-tiles // per)
            if 3 * pairs * splits > sms:
                continue
            scratch = torch.empty(splits, 9 * cin, cout, device="cuda")
            dw = torch.empty(9 * cin, cout, device="cuda")
            for stages in STAGES:
                def call(splits=splits, per=per, stages=stages,
                         scratch=scratch, dw=dw):
                    common.launch("conv3x3_wgrad_tc",
                                  lib.odek_conv3x3_wgrad_tc, x.data_ptr(),
                                  None, g.data_ptr(), scratch.data_ptr(),
                                  dw.data_ptr(), b, h, w, cin, cout, tw,
                                  splits, per, stages,
                                  common.DTYPE_CODES[torch.bfloat16],
                                  common.stream_handle(x))
                    return dw
                first = call().clone()
                err = ((first.double() - ref).norm() / ref.norm()).item()
                if err > 5e-6 or not torch.equal(first, call()):
                    raise AssertionError(f"K2 at S {splits} T {per} stages "
                                         f"{stages}: relative L2 {err}, or "
                                         "two calls differ")
                us = device_us(call)
                star = "*" if (per, stages) == (mine_per, 4) else ""
                line.append(f"S {splits} T {per} st {stages}{star}: "
                            f"{us:.2f}")
                rows.append({"shape": [b, h, w, cin, cout],
                             "splits": splits, "tiles_per_split": per,
                             "stages": stages, "device_us": us,
                             "rel_l2": err, "plan": bool(star)})
        print(f"sweep tensor-core K2 bf16 ({b}, {h}, {w}, {cin}) x "
              f"(..., {cout}), device us a call: " + ", ".join(line))
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    rows = sweep()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "rows": rows}))


if __name__ == "__main__":
    main()
