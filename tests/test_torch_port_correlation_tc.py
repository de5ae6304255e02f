"""The design of the tensor-core K5-K7, on the CPU.

The kernels (``csrc/correlation.cu::corr_fwd_tc_kernel``,
``corr_bwd_f1_tc_kernel``, ``corr_bwd_f2_tc_kernel``) cannot run here, so
what they rest on is tested instead:

* the index map they use, pixel pair (p, q) -> displacement i or none
  (``pair_displacements``, computed from the offset q - p as the kernels'
  table is), against a brute-force walk over the forward's windows: every
  (p, i) whose window lies in the map is exactly one pair;
* their algorithm in plain torch, fp32: K5 as S = f1 . f2^T gathered at
  the pairs, K7 as M . f1 with M the cotangent scattered to the pairs, and
  K6's M^T . f2 (the same M), against the JAX Pallas kernels
  (``_correlation_pallas``, ``_correlation_bwd_pallas``) in interpret
  mode, 1e-5 max abs (sums reassociated), and the port's CPU K6 (its
  plain version) against the Pallas K6 at the bench geometry, C = 256;
* the rule ``tc_plan`` that sends a call on the card to those kernels,
  with K5's (f1, f2), K6's (f2, gf1) and K7's (f1) pointers.
"""

import itertools

import numpy as np
import pytest
import torch

from torch_port_util import max_abs, t32
from ode_rl_torch.ops.correlation import (correlation_bwd_f1,
                                          n_displacements, pair_displacements,
                                          tc_plan)

TOL = 1e-5

# (H, W, d, stride): the FlowNetC bench geometry, stride 1 with d = 3,
# H != W, a 7x7 map (odd H*W), d of less than one pixel (only the pixel
# itself), and a map narrower than d.
GEOMETRIES = [(8, 8, 20, 2), (8, 8, 3, 1), (4, 16, 20, 2), (7, 7, 3, 2),
              (8, 8, 0, 1), (5, 3, 4, 1)]


def _windows_in_map(h, w, d, stride) -> dict:
    """{(p, i): q} for every pixel p and displacement i whose window pixel
    q lies in the map, walked from the forward's definition."""
    n = n_displacements(d, stride)
    pairs = {}
    for y, x, iy, ix in itertools.product(range(h), range(w), range(n),
                                          range(n)):
        yy, xx = y + iy * stride - d, x + ix * stride - d
        if 0 <= yy < h and 0 <= xx < w:
            pairs[(y * w + x, iy * n + ix)] = yy * w + xx
    return pairs


@pytest.mark.parametrize("h,w,d,stride", GEOMETRIES)
def test_pair_map_covers_each_in_map_window_exactly_once(h, w, d, stride):
    disp = pair_displacements(h, w, d, stride)
    assert disp.shape == (h * w, h * w)
    assert int(disp.min()) >= -1
    assert int(disp.max()) < n_displacements(d, stride) ** 2
    hits = (disp >= 0).nonzero().tolist()
    found = {(p, int(disp[p, q])): q for p, q in hits}
    assert len(found) == len(hits)  # no (p, i) on two pairs
    assert found == _windows_in_map(h, w, d, stride)


def test_pair_map_at_the_bench_geometry_has_16_pairs_a_pixel():
    """8x8, d = 20, stride 2: 4 of the 21 offsets a side land in the map
    from every pixel, so 16 of the 441 windows; 1,024 pairs in all."""
    disp = pair_displacements(8, 8, 20, 2)
    assert ((disp >= 0).sum(1) == 16).all()
    assert int((disp >= 0).sum()) == 1024


def _rand(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _fwd_by_pairs(f1, f2, d, stride):
    """K5's algorithm: S = f1 . f2^T / C over a sample's pixels, then
    out[p, i] = S[p, q] at each pair (p, q) of displacement i, else 0."""
    b, h, w, c = f1.shape
    disp = pair_displacements(h, w, d, stride)
    p, q = (disp >= 0).nonzero(as_tuple=True)
    s = f1.reshape(b, h * w, c) @ f2.reshape(b, h * w, c).transpose(1, 2) / c
    out = f1.new_zeros(b, h * w, n_displacements(d, stride) ** 2)
    out[:, p, disp[p, q]] = s[:, p, q]
    return out.reshape(b, h, w, -1)


def _pair_matrix(g, d, stride):
    """M (B, H*W, H*W): M[b, q, p] = g[b, p, i] at each pair (p, q) of
    displacement i, else 0 (csrc/correlation.cu::build_pair_matrix)."""
    b, h, w, nd = g.shape
    disp = pair_displacements(h, w, d, stride)
    p, q = (disp >= 0).nonzero(as_tuple=True)
    m = g.new_zeros(b, h * w, h * w)
    m[:, q, p] = g.reshape(b, h * w, nd)[:, p, disp[p, q]]
    return m


def _bwd_by_pairs(g, f1, f2, d, stride):
    """K7's algorithm, gf2 = M . f1 / C, and K6's on the same M, gf1 =
    M^T . f2 / C."""
    b, h, w, c = f1.shape
    m = _pair_matrix(g, d, stride)
    gf1 = m.transpose(1, 2) @ f2.reshape(b, h * w, c) / c
    gf2 = m @ f1.reshape(b, h * w, c) / c
    return gf1.reshape(f1.shape), gf2.reshape(f1.shape)


@pytest.mark.parametrize("h,w,d,stride", GEOMETRIES[:4])
def test_pair_products_match_the_pallas_kernels(h, w, d, stride):
    """B = 2, C = 64, fp32: the forward against ``_correlation_pallas``,
    both backward gradients against ``_correlation_bwd_pallas``, each in
    interpret mode."""
    from ode_rl_tpu.ops.correlation import (_correlation_bwd_pallas,
                                            _correlation_pallas)

    nd = n_displacements(d, stride) ** 2
    f1, f2 = _rand(2, h, w, 64, seed=1), _rand(2, h, w, 64, seed=2)
    g = _rand(2, h, w, nd, seed=3)
    out = _fwd_by_pairs(t32(f1), t32(f2), d, stride)
    ref = _correlation_pallas(f1, f2, d, stride, interpret=True)
    assert out.shape == ref.shape
    assert max_abs(out, ref) <= TOL
    gf1, gf2 = _bwd_by_pairs(t32(g), t32(f1), t32(f2), d, stride)
    ref1, ref2 = _correlation_bwd_pallas(f1, f2, g, d, stride,
                                         interpret=True)
    assert max_abs(gf1, ref1) <= TOL
    assert max_abs(gf2, ref2) <= TOL


def test_cpu_k6_matches_the_pallas_kernel_at_the_bench_geometry():
    """B = 2 of the FlowNetC bench shape (8x8x256, d = 20, stride 2):
    ``correlation_bwd_f1`` on CPU tensors (the plain version the card's K6
    kernels are held to) and the pair-matrix algorithm M^T . f2 / C against
    ``_correlation_bwd_pallas``'s grad f1 in interpret mode."""
    from ode_rl_tpu.ops.correlation import _correlation_bwd_pallas

    d, stride = 20, 2
    f1, f2 = _rand(2, 8, 8, 256, seed=4), _rand(2, 8, 8, 256, seed=5)
    g = _rand(2, 8, 8, n_displacements(d, stride) ** 2, seed=6)
    ref, _ = _correlation_bwd_pallas(f1, f2, g, d, stride, interpret=True)
    out = correlation_bwd_f1(t32(g), t32(f2), d, stride)
    assert out.shape == ref.shape == (2, 8, 8, 256)
    assert max_abs(out, ref) <= TOL
    by_pairs, _ = _bwd_by_pairs(t32(g), t32(f1), t32(f2), d, stride)
    assert max_abs(by_pairs, ref) <= TOL


ALIGNED = (0x7F0000000000, 0x7F0000010000)


@pytest.mark.parametrize("case,expected", [
    # The FlowNetC bench shape (8x8x256, d = 20, stride 2) in bf16, and the
    # card tests' maps of at most 64 pixels.
    pytest.param(dict(h=8, w=8, c=256), True, id="bench"),
    pytest.param(dict(h=8, w=8, c=64), True, id="8x8-c64"),
    pytest.param(dict(h=4, w=16, c=64), True, id="4x16"),
    pytest.param(dict(h=7, w=7, c=128), True, id="7x7"),
    pytest.param(dict(h=8, w=8, c=64, d=3, stride=1), True, id="stride1"),
    pytest.param(dict(h=1, w=1, c=64), True, id="1x1"),
    # fp32 (FlowNet2, the fp32 reference step) stays strict fp32.
    pytest.param(dict(h=8, w=8, c=256, dtype=torch.float32), False,
                 id="fp32"),
    # The FlyingChairs feature map (3,072 pixels), and 72 pixels.
    pytest.param(dict(h=48, w=64, c=256), False, id="chairs"),
    pytest.param(dict(h=8, w=9, c=256), False, id="72-pixels"),
    # Channels that are not whole 128-byte rows, or more rows than the
    # kernels unroll.
    pytest.param(dict(h=8, w=8, c=48), False, id="c48"),
    pytest.param(dict(h=8, w=8, c=32), False, id="c32"),
    pytest.param(dict(h=8, w=8, c=192), False, id="c192"),
    pytest.param(dict(h=8, w=8, c=512), False, id="c512"),
    # A view one bf16 element into its storage, or 8 bytes in.
    pytest.param(dict(h=8, w=8, c=256, ptrs=(ALIGNED[0], ALIGNED[1] + 2)),
                 False, id="misaligned-f2"),
    pytest.param(dict(h=8, w=8, c=256, ptrs=(ALIGNED[0] + 8,)), False,
                 id="misaligned-f1"),
    # K6's pair (f2, gf1): both aligned, or either 8 bytes off.
    pytest.param(dict(h=8, w=8, c=256, ptrs=(ALIGNED[1], ALIGNED[0])), True,
                 id="k6-f2-gf1"),
    pytest.param(dict(h=8, w=8, c=256, ptrs=(ALIGNED[1] + 8, ALIGNED[0])),
                 False, id="k6-misaligned-f2"),
    pytest.param(dict(h=8, w=8, c=256, ptrs=(ALIGNED[1], ALIGNED[0] + 8)),
                 False, id="k6-misaligned-gf1"),
    # K5's staged (64, n*n) output within a block's shared memory (d = 20
    # at stride 1: 1,681 displacements), and beyond it (d = 21: 1,849).
    pytest.param(dict(h=8, w=8, c=64, d=20, stride=1), True,
                 id="d20-stride1"),
    pytest.param(dict(h=8, w=8, c=64, d=21, stride=1), False,
                 id="d21-stride1"),
])
def test_tc_plan_routes_calls(case, expected):
    args = dict(d=20, stride=2, dtype=torch.bfloat16, ptrs=ALIGNED) | case
    assert tc_plan(args["h"], args["w"], args["c"], args["d"],
                   args["stride"], args["dtype"], args["ptrs"]) is expected
