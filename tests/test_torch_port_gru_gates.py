"""K3 and K4 of the PyTorch port: the rule that sends a call on the card to
the one-sample kernels, their cluster plan, the rule and grid of the
moments-in K3's vector kernel (a 'space' axis), and the fp64 reference of
the Pallas kernels' formula that the card checks hold the bf16 kernels to.

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
                                        mom_vec_plan, sample_plan)

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
