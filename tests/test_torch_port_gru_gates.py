"""K3 and K4 of the PyTorch port: the rule that sends a call on the card to
the one-sample kernels, their cluster plan, the rules and grids of the
moments-in K3's and K4's vector kernels and of the vector moments pass (a
'space' axis), the moments pass's summation order emulated against the
plain version, and the fp64 reference of the Pallas kernels' formula that
the card checks hold the bf16 kernels to.

The fp64 reference (``gates_f64``/``blend_f64``) is compared with the JAX
package's ``_gates_kernel``/``_blend_kernel`` run in interpret mode through
``fused_gru_gates``/``fused_gru_blend(..., impl="interpret")`` on the same
numpy inputs in fp32: 1e-5 max abs (the Pallas kernels' fp32 moments over
at most 2,048 elements a group, against fp64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import max_abs
from ode_rl_torch.ops.gru_gates import (_alignment, blend_f64, gates_f64,
                                        gru_moments_plain, mom_vec_plan,
                                        moments_plan, sample_plan)

BF16, F32 = torch.bfloat16, torch.float32

# (B, HW, C, G, dtype, align, blend, plan or None). Accepted: the flagship
# in bf16 (B=128) and fp32 (B=8), K3 and K4 (4 groups over 2C, 2 over C);
# a group straddling the z/r split (2C = 96, G = 3: 480 threads, a multiple
# of 32 and of 12 or 24 vectors a pixel); the card tests' narrow channels;
# fp32 groups of 20 channels (80 bytes). Refused: bf16 groups of 20
# channels (40 bytes), h's channels not whole 16-byte vectors, a base not
# 16-byte aligned, fp16, a pixel of more vectors than a 512-thread block
# can hold in whole rows (2C = 272 bf16 channels in 17 groups of 32
# bytes: lcm(34, 32) = 544).
RULE_CASES = [
    (128, 256, 64, 4, BF16, 256, False, (512, 1, 256)),
    (128, 256, 64, 2, BF16, 256, True, (512, 1, 256)),
    (8, 256, 64, 4, F32, 256, False, (512, 1, 256)),
    (8, 256, 64, 2, F32, 256, True, (512, 1, 256)),
    (3, 35, 48, 3, BF16, 16, False, (480, 1, 35)),
    (3, 35, 48, 1, BF16, 16, True, (480, 1, 35)),
    (3, 35, 48, 3, F32, 16, False, (480, 1, 35)),
    (3, 35, 16, 1, BF16, 16, False, (512, 1, 35)),
    (3, 35, 16, 1, BF16, 16, True, (512, 1, 35)),
    (3, 35, 40, 4, F32, 16, False, (480, 1, 35)),
    (3, 35, 40, 4, BF16, 16, False, None),
    (3, 35, 40, 2, BF16, 16, True, None),
    (3, 35, 4, 1, BF16, 16, False, None),
    (128, 256, 64, 4, BF16, 8, False, None),
    (128, 256, 64, 4, BF16, 2, True, None),
    (128, 256, 64, 4, torch.float16, 256, False, None),
    (2, 64, 136, 17, BF16, 256, False, None),
]


@pytest.mark.parametrize("b,hw,c,groups,dtype,align,blend,expected",
                         RULE_CASES)
def test_sample_rule_and_plan(b, hw, c, groups, dtype, align, blend,
                              expected):
    plan = sample_plan(b, hw, c, groups, dtype, align, blend)
    assert (None if plan is None else tuple(plan)) == expected


# fp32, C = 64, 4 groups, 512 threads: the shared memory left beside the
# partial moments, group statistics and barriers, 232,448 - 4,096 - 64 -
# 40 = 228,248 bytes, holds 297 pixels of 3 x 64 fp32 channels. So one
# block takes up to 297 pixels, a cluster of 8 up to 8 x 297 = 2,376, and
# a larger sample goes to the two-pass kernel.
@pytest.mark.parametrize("hw,ranks", [(297, 1), (298, 2), (1024, 4),
                                      (2376, 8), (2377, None),
                                      (4096, None)])
def test_sample_plan_cluster_boundary(hw, ranks):
    plan = sample_plan(2, hw, 64, 4, F32, 256)
    assert (None if plan is None else plan.ranks) == ranks


def _smem_bytes(plan, c, groups, elem):
    """csrc/gru_gates.cu::sample_smem_bytes."""
    return (plan.px_per_rank * 3 * c * elem + plan.threads * 8 + groups * 16
            + 5 * 8)


@pytest.mark.parametrize("hw", [1, 9, 10, 35, 256, 297, 298, 299, 700,
                                1024, 1500, 2376])
@pytest.mark.parametrize("c,groups,dtype,blend",
                         [(64, 4, F32, False), (64, 2, F32, True),
                          (48, 3, F32, False), (128, 8, BF16, True)])
def test_sample_plan_covers_every_pixel_once(hw, c, groups, dtype, blend):
    """Rank r owns pixels [r * px_per_rank, min(hw, (r + 1) *
    px_per_rank)): together every pixel of a sample once, no rank empty,
    each within a block's shared memory and a portable cluster."""
    plan = sample_plan(4, hw, c, groups, dtype, 16, blend)
    assert plan is not None
    owned = [p for r in range(plan.ranks)
             for p in range(r * plan.px_per_rank,
                            min(hw, (r + 1) * plan.px_per_rank))]
    assert owned == list(range(hw))
    assert all(r * plan.px_per_rank < hw for r in range(plan.ranks))
    assert 1 <= plan.ranks <= 8
    elem = 4 if dtype == F32 else 2
    assert _smem_bytes(plan, c, groups, elem) <= 232_448
    vectors = (c if blend else 2 * c) * elem // 16
    assert plan.threads % 32 == 0 and plan.threads % vectors == 0
    assert plan.threads <= 512


# (B, HW, C, G, dtype, align, threads or None) of the moments-in K3's
# vector kernel. Accepted: a 'space' rank's slice of the flagship (HW 128)
# in bf16 and fp32 (16 and 32 vectors a pixel, 256 threads); a group
# straddling the z/r split (2C = 96, G = 3: 12 or 24 vectors, 252 and 240
# threads); narrow channels (4 vectors); pixels of 512, 768 and 1024
# vectors (one pixel a pass). Refused: bf16 groups of 20 channels (40
# bytes), h's channels not whole 16-byte vectors, a base not 16-byte
# aligned, fp16, B past grid.y, C past 3072 (a_c and b_c past 48 KB), a
# pixel of more than 1024 vectors, a sample past 32-bit offsets.
MOM_VEC_CASES = [
    (128, 128, 64, 4, BF16, 256, 256),
    (128, 128, 64, 4, F32, 256, 256),
    (2, 104, 48, 3, BF16, 16, 252),
    (2, 104, 48, 3, F32, 16, 240),
    (3, 35, 16, 1, BF16, 16, 256),
    (2, 64, 1024, 8, F32, 16, 512),
    (2, 4, 3072, 4, BF16, 16, 768),
    (2, 4, 2048, 4, F32, 16, 1024),
    (3, 35, 40, 4, BF16, 16, None),
    (3, 35, 4, 1, BF16, 16, None),
    (128, 128, 64, 4, BF16, 8, None),
    (128, 128, 64, 4, torch.float16, 256, None),
    (65536, 4, 64, 4, BF16, 16, None),
    (2, 4, 3200, 4, BF16, 16, None),
    (2, 4, 3072, 4, F32, 16, None),
    (1, 2**24, 64, 4, BF16, 16, None),
]


@pytest.mark.parametrize("b,hw,c,groups,dtype,align,expected",
                         MOM_VEC_CASES)
def test_mom_vec_rule(b, hw, c, groups, dtype, align, expected):
    assert mom_vec_plan(b, hw, c, groups, dtype, align) == expected


@pytest.mark.parametrize("hw", [1, 7, 32, 104, 128, 129, 1000])
@pytest.mark.parametrize("c,groups,dtype", [(64, 4, BF16), (64, 4, F32),
                                            (48, 3, BF16), (16, 1, BF16)])
def test_mom_vec_grid_covers_every_vector_once(hw, c, groups, dtype):
    """csrc/gru_gates.cu::gru_gates_mom_vec_kernel's grid, emulated: block
    k's thread t takes slot t % V of pixels k * R * 2 + t // V + j * R (j =
    0, 1; R = threads / V) below HW; together every (pixel, vector) of a
    sample once. Each vector's channels lie in z or in r and in one
    group."""
    threads = mom_vec_plan(2, hw, c, groups, dtype, 16)
    elem = 4 if dtype == F32 else 2
    vec = 16 // elem
    v = 2 * c // vec
    rows = threads // v
    blocks = -(-hw // (rows * 2))
    seen = [(k * rows * 2 + t // v + j * rows, t % v)
            for k in range(blocks) for t in range(threads) for j in range(2)
            if k * rows * 2 + t // v + j * rows < hw]
    assert sorted(seen) == [(p, s) for p in range(hw) for s in range(v)]
    cs = 2 * c // groups
    for s in range(v):
        chans = range(s * vec, (s + 1) * vec)
        assert len({ch // c for ch in chans}) == 1
        assert len({ch // cs for ch in chans}) == 1


# (B, HW, C, G, dtype, align, threads or None) of the moments-in K4's
# vector kernel (mom_vec_plan with blend: C channels of cand). Accepted: a
# 'space' rank's candidate slice of the flagship (C 64, G 2: 8 and 16
# vectors a pixel, 256 threads); groups of 16 channels (C 48, G 3: 6 or 12
# vectors, 252); narrow channels (C 16, G 1: 2 or 4 vectors); C 4096 bf16
# (512 vectors, one pixel a pass of the largest block). Refused: bf16
# groups of 20 channels (40 bytes), C 4 in bf16 (8 bytes), a base not
# 16-byte aligned, fp16, B past grid.y, C past 6144 (a_c and b_c past 48
# KB), C 6144 in bf16 (768 vectors a pixel, past K4's 512 threads; K3
# takes 768), a sample past 32-bit offsets.
BLEND_MOM_VEC_CASES = [
    (128, 128, 64, 2, BF16, 256, 256),
    (128, 128, 64, 2, F32, 256, 256),
    (2, 104, 48, 3, BF16, 16, 252),
    (2, 104, 48, 3, F32, 16, 252),
    (3, 35, 16, 1, BF16, 16, 256),
    (3, 35, 16, 1, F32, 16, 256),
    (2, 4, 4096, 4, BF16, 16, 512),
    (3, 35, 40, 2, BF16, 16, None),
    (3, 35, 4, 1, BF16, 16, None),
    (128, 128, 64, 2, BF16, 8, None),
    (128, 128, 64, 2, torch.float16, 256, None),
    (65536, 4, 64, 2, BF16, 16, None),
    (2, 4, 6400, 4, BF16, 16, None),
    (2, 4, 6144, 4, BF16, 16, None),
    (1, 2**25, 64, 2, BF16, 16, None),
]


@pytest.mark.parametrize("b,hw,c,groups,dtype,align,expected",
                         BLEND_MOM_VEC_CASES)
def test_blend_mom_vec_rule(b, hw, c, groups, dtype, align, expected):
    assert mom_vec_plan(b, hw, c, groups, dtype, align, True) == expected


@pytest.mark.parametrize("hw", [1, 7, 32, 104, 128, 129, 1000])
@pytest.mark.parametrize("c,groups,dtype", [(64, 2, BF16), (64, 2, F32),
                                            (48, 3, BF16), (16, 1, BF16)])
def test_blend_mom_vec_grid_covers_every_vector_once(hw, c, groups, dtype):
    """csrc/gru_gates.cu::gru_blend_mom_vec_kernel's grid, emulated: block
    k's thread t takes slot t % V of pixels k * R * 2 + t // V + j * R (j =
    0, 1; R = threads / V, V = C / kVec) below HW; together every (pixel,
    vector) of a sample once, and each vector's channels in one group."""
    threads = mom_vec_plan(2, hw, c, groups, dtype, 16, True)
    vec = 16 // (4 if dtype == F32 else 2)
    v = c // vec
    rows = threads // v
    blocks = -(-hw // (rows * 2))
    seen = [(k * rows * 2 + t // v + j * rows, t % v)
            for k in range(blocks) for t in range(threads) for j in range(2)
            if k * rows * 2 + t // v + j * rows < hw]
    assert sorted(seen) == [(p, s) for p in range(hw) for s in range(v)]
    cs = c // groups
    assert all(len({ch // cs for ch in range(s * vec, (s + 1) * vec)}) == 1
               for s in range(v))


# (B, HW, Ct, G, dtype, align, (threads, ranks, px_per_rank) or None) of
# the vector moments pass. Accepted: a 'space' rank's gates (2C 128, G 4)
# and candidate (C 64, G 2) of the flagship in bf16 (16 and 8 vectors a
# pixel: 256 threads, 16 and 32 pixels a pass, 8 and 4 passes, one block a
# sample) and fp32 (32 and 16 vectors; the gates' 16 passes on a cluster
# of 2); the whole frame's gates in bf16 (16 passes, 2 blocks); groups of
# 32 channels over 96 (V 12: 192 threads, a run longer than the 104
# pixels); narrow channels (Ct 16: 256 threads); 512 pixels on 4 blocks;
# 10,000 pixels on 8 blocks of 79 passes each. Refused: bf16 groups of
# 20 channels (40 bytes), Ct 4 in bf16 (8 bytes), a base not 16-byte
# aligned, fp16, 33 fp32 vectors a pixel (lcm(33, 32) = 1056 threads past
# 1024), a sample past 32-bit offsets.
MOMENTS_PLAN_CASES = [
    (128, 128, 128, 4, BF16, 256, (256, 1, 128)),
    (128, 128, 64, 2, BF16, 256, (256, 1, 128)),
    (8, 128, 128, 4, F32, 256, (256, 2, 64)),
    (8, 128, 64, 2, F32, 256, (256, 1, 128)),
    (128, 256, 128, 4, BF16, 256, (256, 2, 128)),
    (2, 104, 96, 3, BF16, 16, (192, 1, 112)),
    (3, 35, 16, 1, BF16, 16, (256, 1, 128)),
    (2, 512, 128, 4, BF16, 16, (256, 4, 128)),
    (2, 10000, 128, 4, BF16, 16, (256, 8, 1264)),
    (3, 35, 80, 4, BF16, 16, None),
    (3, 35, 4, 1, BF16, 16, None),
    (128, 128, 128, 4, BF16, 8, None),
    (128, 128, 128, 4, torch.float16, 256, None),
    (2, 64, 132, 33, F32, 16, None),
    (1, 2**24, 128, 4, BF16, 16, None),
]


@pytest.mark.parametrize("b,hw,ct,groups,dtype,align,expected",
                         MOMENTS_PLAN_CASES)
def test_moments_rule_and_plan(b, hw, ct, groups, dtype, align, expected):
    plan = moments_plan(b, hw, ct, groups, dtype, align)
    assert (None if plan is None else tuple(plan)) == expected


MOMENTS_GRID = [(128, 4, BF16), (128, 4, F32), (64, 2, BF16),
                (96, 3, BF16), (16, 1, BF16)]


@pytest.mark.parametrize("hw", [1, 7, 104, 128, 129, 300, 1000, 10000])
@pytest.mark.parametrize("ct,groups,dtype", MOMENTS_GRID)
def test_moments_vec_grid_covers_every_vector_once(hw, ct, groups, dtype):
    """csrc/gru_gates.cu::gru_moments_vec_kernel's grid, emulated: rank r's
    thread t takes slot t % V of pixels r * px_per_rank + t // V + k * P
    (P = threads / V) below min(HW, (r + 1) * px_per_rank); together every
    (pixel, vector) of a sample once, no rank empty, at most 8 ranks,
    each thread's pixels in one batch of 8 loads where the cluster has
    room, each vector's channels in one group; the block a multiple of 32
    (whole warps for the groups' sums) and of V."""
    plan = moments_plan(2, hw, ct, groups, dtype, 16)
    vec = 16 // (4 if dtype == F32 else 2)
    v = ct // vec
    rows = plan.threads // v
    seen = [(p, t % v) for r in range(plan.ranks)
            for t in range(plan.threads)
            for p in range(r * plan.px_per_rank + t // v,
                           min(hw, (r + 1) * plan.px_per_rank), rows)]
    assert sorted(seen) == [(p, s) for p in range(hw) for s in range(v)]
    assert all(r * plan.px_per_rank < hw for r in range(plan.ranks))
    assert 1 <= plan.ranks <= 8
    assert plan.ranks == 8 or plan.px_per_rank <= 8 * rows
    assert plan.threads % 32 == 0 and plan.threads % v == 0
    cs = ct // groups
    assert all(len({ch // cs for ch in range(s * vec, (s + 1) * vec)}) == 1
               for s in range(v))


def _moments_in_plan_order(x, groups, plan, vec):
    """gru_moments_vec_kernel's sums of x (B, HW, Ct) fp32 in its order,
    in fp32: each thread's pixels ascending, then its vector's elements (s2
    by an FMA, emulated in fp64 and rounded once); each group's slots of
    every row by the 32 lanes of one warp (lane i % 32 takes the i-th in
    turn), then the xor butterfly; then the ranks in order. A pixel past a
    run's end adds zeros, which leave every fp32 sum as it is."""
    f32 = np.float32
    b, hw, ct = x.shape
    v, nj = ct // vec, ct // groups // vec
    rows = plan.threads // v
    out = np.zeros((b, groups, 2), f32)
    for r in range(plan.ranks):
        run = x[:, r * plan.px_per_rank:(r + 1) * plan.px_per_rank]
        passes = -(-run.shape[1] // rows)
        pad = np.zeros((b, passes * rows, ct), f32)
        pad[:, :run.shape[1]] = run
        vals = pad.reshape(b, passes, rows, v, vec)
        s1 = np.zeros((b, rows, v), f32)
        s2 = np.zeros((b, rows, v), f32)
        for k in range(passes):
            for e in range(vec):
                val = vals[:, k, :, :, e]
                s1 = s1 + val
                s2 = (val.astype(np.float64) ** 2 + s2).astype(f32)
        part = np.stack([s1, s2], -1)  # (b, row, slot, 2)
        for g in range(groups):
            # i = row * nj + j: slot g * nj + j of row i // nj.
            seq = part[:, :, g * nj:(g + 1) * nj].reshape(b, rows * nj, 2)
            seq = np.concatenate(
                [seq, np.zeros((b, -len(seq[0]) % 32, 2), f32)], 1)
            lanes = np.zeros((b, 32, 2), f32)
            for k in range(seq.shape[1] // 32):
                lanes = lanes + seq[:, 32 * k:32 * (k + 1)]
            for off in (16, 8, 4, 2, 1):
                lanes = lanes + lanes[:, np.arange(32) ^ off]
            out[:, g] = out[:, g] + lanes[:, 0]
    return out


@pytest.mark.parametrize("hw,ct,groups,dtype,ranks", [
    (128, 128, 4, BF16, 1), (128, 64, 2, BF16, 1), (128, 128, 4, F32, 2),
    (104, 96, 3, BF16, 1), (35, 16, 1, BF16, 1), (300, 128, 4, BF16, 3),
    (1000, 64, 2, F32, 8)])
def test_moments_in_plan_order_match_plain(hw, ct, groups, dtype, ranks):
    """The vector moments pass's summation order (slots, then groups by
    one warp, then the cluster's ranks), emulated in fp32 on seeded
    inputs of ``dtype``, against gru_moments_plain and fp64 sums: within
    1e-5 of the largest sum, as the card holds the kernel (fp32 sums of at
    most 16,000 elements a group). The fp32 gates slice and 300 and 1,000
    pixels split a sample over a cluster."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, hw, ct).astype(np.float32)).to(dtype)
    plan = moments_plan(2, hw, ct, groups, dtype, 16)
    assert plan.ranks == ranks
    vec = 16 // (4 if dtype == F32 else 2)
    got = _moments_in_plan_order(x.float().numpy(), groups, plan, vec)
    xd = x.double().reshape(2, hw, groups, ct // groups)
    f64 = torch.stack([xd.sum(dim=(1, 3)), (xd * xd).sum(dim=(1, 3))], -1)
    for ref in (gru_moments_plain(x.reshape(2, hw, 1, ct), groups), f64):
        ref = ref.double().numpy()
        assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-5


def test_alignment_of_views():
    base = torch.zeros(64, dtype=BF16)
    assert _alignment(base.data_ptr()) % 16 == 0
    assert _alignment(base.data_ptr(), base[1:].data_ptr()) == 2
    assert _alignment(torch.zeros(8)[1:].data_ptr()) == 4


def _gates_inputs(rng, shape, groups):
    b, h, w, c = shape
    return [rng.randn(b, h, w, 2 * c).astype(np.float32),
            np.tanh(rng.randn(b, h, w, c)).astype(np.float32),
            rng.uniform(0.5, 1.5, 2 * c).astype(np.float32),
            (0.1 * rng.randn(2 * c)).astype(np.float32)]


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 64), 4),
                                          ((2, 5, 7, 48), 3)])
def test_gates_f64_matches_pallas_gates_kernel(shape, groups):
    from ode_rl_tpu.ops.gru_gates import fused_gru_gates as jax_gates

    arrays = _gates_inputs(np.random.RandomState(5), shape, groups)
    ref = jax_gates(*[jnp.asarray(a) for a in arrays], groups,
                    impl="interpret")
    out = gates_f64(*[torch.from_numpy(a) for a in arrays], groups)
    for o, r in zip(out, ref):
        assert o.dtype == torch.float64
        assert max_abs(o, r) <= 1e-5


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 64), 2),
                                          ((2, 5, 7, 48), 1)])
def test_blend_f64_matches_pallas_blend_kernel(shape, groups):
    from ode_rl_tpu.ops.gru_gates import fused_gru_blend as jax_blend

    rng = np.random.RandomState(6)
    b, h, w, c = shape
    arrays = [rng.randn(b, h, w, c).astype(np.float32),
              (1 / (1 + np.exp(-rng.randn(b, h, w, c)))).astype(np.float32),
              np.tanh(rng.randn(b, h, w, c)).astype(np.float32),
              rng.uniform(0.5, 1.5, c).astype(np.float32),
              (0.1 * rng.randn(c)).astype(np.float32)]
    ref = jax_blend(*[jnp.asarray(a) for a in arrays], groups,
                    impl="interpret")
    out = blend_f64(*[torch.from_numpy(a) for a in arrays], groups)
    assert out.dtype == torch.float64
    assert max_abs(out, ref) <= 1e-5
