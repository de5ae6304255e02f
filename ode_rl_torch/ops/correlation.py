"""FlowNetC's local cost volume: kernels K5, K6 and K7.

Counterpart of ``ode_rl_tpu/ops/correlation.py``. For each pixel and each
displacement (oy, ox) = (iy*stride - d, ix*stride - d), iy, ix < n with
n = 2d/stride + 1, the channel mean of f1 times the shifted f2, zero where
the window leaves the image. Output (B, H, W, n*n), displacement-major
(441 channels for FlowNetC's d = 20, stride 2).

* K5 ``correlation_fwd`` (``csrc/correlation.cu``): the forward. Its plain
  version is ``_correlation_xla`` written out over the displacements.
* K6 ``correlation_bwd_f1``: grad f1 = sum_i g_i * window_i(f2) / C.
* K7 ``correlation_bwd_f2``: grad f2 as a gather, sum over the output
  pixels whose windows cover it of g_i * f1 / C. Its plain version is that
  gather formula, not autograd of the forward, so the plain backward the
  kernels are held to is tested on its own.

On the card K5, K6 and K7 each take one of two kernels by ``tc_plan``.
The tensor-core kernels (bf16, maps of at most 64 pixels, C = 64, 128 or
256: the FlowNetC bench shape) give a sample to one block and turn the
correlation into products over pixel pairs (``pair_displacements``):
K5 is S = f1 . f2^T gathered at the pairs, K7 is M . f1 with M the
cotangent scattered to the pairs, K6 is M^T . f2 on the same M. At the
bench shape K5, K6 and K7 take about 13.3, 10.5 and 10.4 µs a call alone,
against 96, 89 and 103 for the first SIMT kernels; the bytes bounds are
9.3 (K5) and 5.2 (K6, K7) (H100 80GB HBM3, 700 W; PERF.md).
Every other call takes the SIMT kernels (fp32, so it stays strict fp32;
the FlyingChairs feature maps; misaligned views). They split the map into
parity classes (``class_axis``): at stride s a pixel meets only the
pixels of one other class, on a dense grid, so a tile of cells and its
halo of partners are staged in shared memory and reused from registers.
``simt_plan`` picks their tiles, or, on maps of at most 32 cells a class
(the 8 x 8 label and trainer features), the pair view: every (cell,
partner) pair of a (sample, class). K6 and K7 add each output's
displacements in increasing i, as their plain versions do, so in bf16
they are bit-equal to them.

``CorrelationFn`` is the ``custom_vjp`` of ``_corr_with_vjp``: K5 forward,
K6 and K7 backward. The JAX package falls back to autograd of the XLA
formula where its backward kernels would overflow the TPU's VMEM; a GPU
gather has no such limit, so the port runs K6 and K7 at every shape.

The plain versions compute in fp32 (fp64 for fp64 inputs, as references)
and round once to the input dtype, as the kernels do.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ode_rl_torch.ops import common
from ode_rl_torch.ops._build import library

# The SIMT K5-K7 (csrc/correlation.cu::corr_fwd_simt_kernel,
# corr_fwd_pairs_kernel, corr_bwd_f1_simt_kernel, corr_bwd_f1_pairs_kernel,
# corr_bwd_f2_simt_kernel, corr_bwd_f2_pairs_kernel), as the source fixes
# them: output cells a micro-tile along x, most threads a block, the
# H100's shared memory a block; K5's tile rows, partners a micro-tile,
# channels a chunk and a staged pixel's pitch in floats; the most cells a
# class may have for a pair view and K5's partners a thread; K6's and
# K7's channels a micro-tile.
_SIMT_R = 4
_SIMT_THREADS = 256
_FWD_THREADS = 192  # K5's tiles: most threads a block
_SMEM_BYTES = 232_448
_FWD_ROWS, _FWD_Q, _FWD_CK, _FWD_CKP = 2, 8, 32, 36
_PAIR_CELLS, _PAIR_Q = 32, 4
_BWD_S = 16
# Tiles are at most this many cells wide (a highres class row, 28, fits).
_TX_MAX = 32
# Shared memory a plan keeps within where it can: two blocks an SM.
_SMEM_HALF = _SMEM_BYTES // 2 - 1024
# K6's and K7's plans (_bwd_simt_plan): widest tile, most channel groups
# of 16 a block, most threads of a pair-view block. K6's, from a sweep on
# the card (PERF.md, PR 18): tiles 16 cells wide, so that 256 threads
# hold 4 rows of all 256 channels and each staged halo row serves more
# outputs; pair-view blocks of 128 threads (two slices, twice the blocks
# on the trainers' 8 x 8 maps).
_BWD_F1_SHAPE = (16, 16, 128)
_BWD_F2_SHAPE = (_TX_MAX, 8, _SIMT_THREADS)

# The tensor-core K5-K7 (csrc/correlation.cu::corr_fwd_tc_kernel,
# corr_bwd_f1_tc_kernel, corr_bwd_f2_tc_kernel): a sample's map is one tile
# of at most 64 pixels, and the channel products are unrolled for these
# widths (one, two or four 64-channel rows of the 128-byte swizzle).
_TC_PIXELS = 64
_TC_CHANNELS = (64, 128, 256)
# K5 stages a sample's (64, n*n) bf16 output in shared memory: 16 bytes of
# lead and 1 KB of alignment within the H100's 232,448 bytes a block, less
# 1 KB for the static pixel table. The feature tiles (at most 64 KB) are
# smaller.
_TC_MAX_DISPLACEMENTS = (232_448 - 2 * 1024 - 16) // (_TC_PIXELS * 2)


def n_displacements(max_displacement: int, stride: int) -> int:
    """n per axis; the cost volume has n*n channels."""
    if max_displacement < 0 or stride < 1:
        raise ValueError(f"correlation: max_displacement {max_displacement} "
                         f"and stride {stride} must be >= 0 and >= 1")
    return 2 * max_displacement // stride + 1


def pair_displacements(h: int, w: int, max_displacement: int,
                       stride: int) -> torch.Tensor:
    """(H*W, H*W) int64: entry (p, q) is the displacement i that takes
    pixel p to pixel q (q = p + (iy*stride - d, ix*stride - d), i = iy*n +
    ix), or -1 where none does. Each (p, i) whose window lies in the map is
    exactly one entry. The tensor-core kernels' index map, computed as
    ``csrc/correlation.cu::build_pair_table`` does: from the offset
    q - p."""
    d, n = max_displacement, n_displacements(max_displacement, stride)
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    ty = ys[None, :] - ys[:, None] + d  # (p, q): offset + d
    tx = xs[None, :] - xs[:, None] + d
    iy, ix = ty.div(stride, rounding_mode="floor"), tx.div(
        stride, rounding_mode="floor")
    ok = ((ty >= 0) & (tx >= 0) & (ty % stride == 0) & (tx % stride == 0)
          & (iy < n) & (ix < n))
    return torch.where(ok, iy * n + ix, torch.full_like(iy, -1))


def tc_plan(h: int, w: int, c: int, max_displacement: int, stride: int,
            dtype: torch.dtype, ptrs: tuple) -> bool:
    """The rule that sends a K5, K6 or K7 call on the card to its
    tensor-core kernel (True) or to its SIMT kernel (False). The
    tensor-core kernels take bf16 (fp32 stays on SIMT, so it stays strict
    fp32), a map of at most 64 pixels (one wgmma tile), C = 64, 128 or 256
    (FlowNetC's correlation is 256 wide), the pointers ``ptrs`` 16-byte
    aligned (16-byte copies: f1 and f2 for K5, f2 and gf1 for K6, f1 for
    K7) and an output row K5 can stage in shared memory. The library
    refuses only what its kernels cannot index
    (csrc/correlation.cu::tc_args_ok)."""
    return (math.gcd(*ptrs) % 16 == 0
            and _tc_shape(h, w, c, max_displacement, stride, dtype))


@functools.lru_cache(maxsize=256)
def _tc_shape(h, w, c, max_displacement, stride, dtype) -> bool:
    """tc_plan's part that the shape decides; cached, since it runs on
    every launch."""
    return (dtype == torch.bfloat16 and 1 <= h * w <= _TC_PIXELS
            and c in _TC_CHANNELS
            and n_displacements(max_displacement, stride) ** 2
            <= _TC_MAX_DISPLACEMENTS)


class SimtPlan(NamedTuple):
    """One SIMT kernel's launch. ``kernel``: "tiles" or "pairs" (the pair
    view); grid (blocks, grid.y); threads a block; tile (K5 tiles: rows,
    tx, ny; K5 pairs: units a block; K6 and K7 tiles: ty, tx, ncg; their
    pairs: ncg); channels a chunk (K5) or a block (K6, K7); dynamic shared
    bytes; and ``args``, the ints the C entry point takes after the
    geometry (the tile and the threads)."""
    kernel: str
    grid: tuple
    threads: int
    tile: tuple
    chunk: int
    smem_bytes: int
    args: tuple


def _cells(r: int, size: int, stride: int) -> int:
    return -(-(size - r) // stride) if r < size else 0


def class_axis(r: int, size: int, max_displacement: int,
               stride: int) -> tuple:
    """One axis of parity class r (the pixels r, r + stride, ... of a map
    ``size`` wide): (cells, partner class r2, offset k, partner cells).
    Every offset i*stride - d is congruent to -d modulo the stride, so cell
    a of class r meets cell a + k + i of class r2 = (r - d) mod stride at
    displacement index i, and nothing else. As
    ``csrc/correlation.cu::class_axis``."""
    d = max_displacement
    r2 = (r - d) % stride
    return (_cells(r, size, stride), r2, (r - d - r2) // stride,
            _cells(r2, size, stride))


def _div_up(a: int, b: int) -> int:
    return -(-a // b)


def fwd_simt_geometry(tx: int, ny: int, h: int, w: int, n: int,
                      stride: int) -> dict:
    """K5's tile geometry, as csrc/correlation.cu's fwd_* helpers: partner
    rows and columns staged at most, slots a staged partner row (its
    columns and ``_FWD_Q - 1`` more read past the last), partner chunks a
    micro-tile, pixel slots a stage (``_FWD_CKP`` floats each), the
    dynamic shared bytes and the micro-tiles (threads) a block."""
    rows = min(_FWD_ROWS + ny - 1, _div_up(h, stride))
    cols = min(tx + n - 1, _div_up(w, stride))
    row_slots = cols + _FWD_Q - 1
    chunks = _div_up(min(n + _SIMT_R - 1, cols), _FWD_Q)
    slots = _FWD_ROWS * tx + rows * row_slots
    smem = 4 * max(2 * _FWD_CKP * slots, _FWD_ROWS * tx * ny * n)
    return dict(rows=rows, cols=cols, row_slots=row_slots, chunks=chunks,
                slots=slots, smem=smem,
                jobs=rows * (tx // _SIMT_R) * chunks)


def _fwd_simt_plan(b, h, w, c, n, stride) -> SimtPlan:
    """K5's launch. Classes of at most ``_PAIR_CELLS`` cells take the pair
    view: as many units as make 64 threads (one, at 4 x 4 cells: many
    small blocks hide the round trips of their one or two stages), stages
    of at most 48 KB. Larger ones take tiles: the widest row up to
    ``_TX_MAX`` cells, then the ny whose micro-tiles, summed over the
    blocks, are fewest (ties: the larger ny), within 192 threads and
    shared memory for two blocks an SM where that is possible."""
    rows, cols = _div_up(h, stride), _div_up(w, stride)
    if rows * cols <= _PAIR_CELLS:
        cells = rows * cols
        np4 = _div_up(cells, 4) * 4
        per_unit = cells * (np4 // _PAIR_Q)
        units = max(1, min(64 // per_unit, b * stride ** 2))
        plane = 2 * np4 + 4
        ck = min(c, max(1, 48 * 1024 // (4 * units * plane)))
        ck = _div_up(c, _div_up(c, ck))  # even stages
        threads = _div_up(units * per_unit, 32) * 32
        return SimtPlan("pairs", (_div_up(b * stride ** 2, units), 1),
                        threads, (units,), ck, 4 * units * ck * plane,
                        (units, ck, threads))
    tx = min(_div_up(cols, _SIMT_R) * _SIMT_R, _TX_MAX)
    while (tx > _SIMT_R and
           fwd_simt_geometry(tx, 1, h, w, n, stride)["jobs"] > _FWD_THREADS):
        tx -= _SIMT_R
    for limit in (_SMEM_HALF, _SMEM_BYTES):
        best = None
        for ny in range(1, n + 1):
            geo = fwd_simt_geometry(tx, ny, h, w, n, stride)
            if geo["jobs"] > _FWD_THREADS or geo["smem"] > limit:
                continue
            key = (_div_up(n, ny) * geo["rows"], -ny)
            if best is None or key < best[0]:
                best = (key, ny, geo)
        if best is not None:
            break
    else:
        raise ValueError(f"correlation_fwd: {n} displacements a row do not "
                         f"fit the SIMT kernel's block")
    _, ny, geo = best
    threads = _div_up(geo["jobs"], 32) * 32
    blocks = (stride ** 2 * _div_up(rows, _FWD_ROWS) * _div_up(cols, tx)
              * _div_up(n, ny))
    return SimtPlan("tiles", (blocks, b), threads, (_FWD_ROWS, tx, ny),
                    _FWD_CK, geo["smem"], (tx, ny, threads))


def bwd_simt_smem(ty: int, tx: int, ncg: int, n: int,
                  feature_bytes: int = 4) -> int:
    """K6's or K7's dynamic shared bytes: two stages of a halo row of
    features (16*ncg channels of ``feature_bytes``: K7 widens bf16 to
    fp32, K6 keeps it; csrc/correlation.cu::bwd_stage_bytes) and its
    fp32 pair matrix (ty, tx + n - 1, tx)."""
    halo_w = tx + n - 1
    return 2 * (halo_w * 16 * ncg * feature_bytes + 4 * ty * halo_w * tx)


def _bwd_simt_plan(b, h, w, c, n, stride, tx_max, ncg_max, pair_threads,
                   feature_bytes=4) -> SimtPlan:
    """K6's or K7's launch (their tiles and pair views have one geometry:
    an output tile, its halo of the other class, a pair matrix). Classes
    of at most ``_PAIR_CELLS`` cells take the pair view: a block a
    (sample, class, channel slice) of at most ``pair_threads``, a thread a
    cell by 16 channels. Larger ones take tiles up to ``tx_max`` cells
    wide and ``16 * ncg_max`` channels (a slice reads the cotangent once),
    and as many rows as fill 256 threads, fewer where the shared memory
    would pass half the block's (two blocks an SM), then fewer channels
    and narrower where it would pass all of it. ``feature_bytes``: a
    staged feature channel's (K7 widens bf16 to fp32, K6 keeps it)."""
    rows, cols = _div_up(h, stride), _div_up(w, stride)
    if rows * cols <= _PAIR_CELLS:
        cells = rows * cols
        ncg = min(_div_up(c, _BWD_S), pair_threads // cells)
        threads = _div_up(cells * ncg, 32) * 32
        return SimtPlan("pairs",
                        (stride ** 2 * _div_up(c, _BWD_S * ncg), b),
                        threads, (ncg,), _BWD_S * ncg,
                        cells * (_BWD_S * ncg * feature_bytes + 4 * cells),
                        (ncg, threads))
    tx = min(_div_up(cols, _SIMT_R) * _SIMT_R, tx_max)
    ncg = min(ncg_max, _div_up(c, _BWD_S))
    while True:
        per_row = tx // _SIMT_R * ncg
        ty = max(1, min(rows, _SIMT_THREADS // per_row))
        smem = bwd_simt_smem(ty, tx, ncg, n, feature_bytes)
        while ty > 1 and smem > _SMEM_HALF:
            ty -= 1
            smem = bwd_simt_smem(ty, tx, ncg, n, feature_bytes)
        if smem <= _SMEM_BYTES:
            break
        if ncg > 1:
            ncg //= 2
        elif tx > _SIMT_R:
            tx -= _SIMT_R
        else:
            raise ValueError(f"correlation backward: {n} displacements a "
                             f"row do not fit the SIMT kernel's block")
    threads = max(32, _div_up(ty * per_row, 32) * 32)
    blocks = (stride ** 2 * _div_up(rows, ty) * _div_up(cols, tx)
              * _div_up(c, _BWD_S * ncg))
    return SimtPlan("tiles", (blocks, b), threads, (ty, tx, ncg),
                    _BWD_S * ncg, smem, (ty, tx, ncg, threads))


@functools.lru_cache(maxsize=256)
def simt_plan(b: int, h: int, w: int, c: int, max_displacement: int,
              stride: int, dtype: torch.dtype) -> dict:
    """The launches of the SIMT K5-K7 for features (b, h, w, c):
    {"correlation_fwd": SimtPlan, "correlation_bwd_f1": SimtPlan,
    "correlation_bwd_f2": SimtPlan}.
    Raises ValueError for what the kernels cannot index: an empty shape, a
    dtype other than fp32 and bf16, a batch beyond the grid's 65,535, a
    grid beyond 2**31 - 1 blocks, or a displacement row too long for a
    block's shared memory (csrc/correlation.cu::simt_tile_ok). Cached: it
    runs on every launch."""
    n = n_displacements(max_displacement, stride)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"correlation: SIMT kernels take float32 and "
                         f"bfloat16, not {dtype}")
    if min(b, h, w, c) < 1 or b > 65_535:
        raise ValueError(f"correlation: features ({b}, {h}, {w}, {c}) are "
                         f"outside the SIMT kernels' grid")
    plans = {"correlation_fwd": _fwd_simt_plan(b, h, w, c, n, stride),
             "correlation_bwd_f1": _bwd_simt_plan(
                 b, h, w, c, n, stride, *_BWD_F1_SHAPE, dtype.itemsize),
             "correlation_bwd_f2": _bwd_simt_plan(b, h, w, c, n, stride,
                                                  *_BWD_F2_SHAPE)}
    if any(p.grid[0] >= 2 ** 31 for p in plans.values()):
        raise ValueError(f"correlation: features ({b}, {h}, {w}, {c}) at "
                         f"stride {stride} need more blocks than a grid has")
    return plans


def _padded_offsets(max_displacement: int, stride: int):
    """(dy, dx) of each displacement into f2 padded by d on each side."""
    n = n_displacements(max_displacement, stride)
    return [(iy * stride, ix * stride) for iy in range(n) for ix in range(n)]


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in its accumulation dtype: fp32, or fp64 for fp64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _pad_hw(x: torch.Tensor, d: int) -> torch.Tensor:
    return F.pad(_acc(x), (0, 0, d, d, d, d))


def correlation_fwd_plain(f1, f2, max_displacement, stride):
    b, h, w, c = f1.shape
    f1f = _acc(f1)
    f2p = _pad_hw(f2, max_displacement)
    out = torch.stack([(f1f * f2p[:, dy:dy + h, dx:dx + w]).mean(-1)
                       for dy, dx in _padded_offsets(max_displacement,
                                                     stride)], dim=-1)
    return out.to(f1.dtype)


def correlation_bwd_f1_plain(g, f2, max_displacement, stride):
    b, h, w, c = f2.shape
    gf = _acc(g)
    f2p = _pad_hw(f2, max_displacement)
    acc = torch.zeros_like(f2p[:, :h, :w])
    for i, (dy, dx) in enumerate(_padded_offsets(max_displacement, stride)):
        acc += gf[..., i, None] * f2p[:, dy:dy + h, dx:dx + w]
    return (acc / c).to(f2.dtype)


def correlation_bwd_f2_plain(g, f1, max_displacement, stride):
    """grad f2[q] = sum_i g_i[q - o_i] * f1[q - o_i] / C over sources in
    bounds: g and f1 padded by d with zeros, read at q + d - o_i."""
    d = max_displacement
    b, h, w, c = f1.shape
    gp = _pad_hw(g, d)
    f1p = _pad_hw(f1, d)
    acc = torch.zeros_like(f1p[:, :h, :w])
    for i, (dy, dx) in enumerate(_padded_offsets(d, stride)):
        sy, sx = 2 * d - dy, 2 * d - dx
        acc += (gp[:, sy:sy + h, sx:sx + w, i, None]
                * f1p[:, sy:sy + h, sx:sx + w])
    return (acc / c).to(f1.dtype)


def _check_nhwc_pair(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 4 or a.shape != b.shape:
        raise ValueError(f"{name}: expected two NHWC tensors of one shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")


def _check_cotangent(name, g, f, n) -> None:
    if g.shape != (*f.shape[:3], n * n):
        raise ValueError(f"{name}: cotangent {tuple(g.shape)} does not match "
                         f"{(*f.shape[:3], n * n)}")


def _launch(name, fn, a, b, out, features, max_displacement, stride,
            plan=None):
    """Launch with pointers (a, b, out) and the (B, H, W, C) of the
    feature maps, and a SIMT kernel's tile and threads from ``plan``."""
    bb, h, w, c = features.shape
    extra = () if plan is None else plan.args
    common.launch(name, fn, a.data_ptr(), b.data_ptr(), out.data_ptr(), bb, h,
                  w, c, max_displacement, stride, *extra,
                  common.DTYPE_CODES[features.dtype],
                  common.stream_handle(features))


def _use_tc(name, kernel, features, ptrs, max_displacement,
            stride) -> bool:
    """Whether a K5, K6 or K7 call on the card takes its tensor-core kernel:
    ``kernel`` "rule" as tc_plan says for the feature shape and the
    pointers ``ptrs``, "tc" the same but raising outside the rule, "simt"
    never."""
    if kernel == "simt":
        return False
    _, h, w, c = features.shape
    tc = tc_plan(h, w, c, max_displacement, stride, features.dtype, ptrs)
    if kernel == "tc" and not tc:
        raise ValueError(f"{name}: {tuple(features.shape)} {features.dtype}, "
                         f"d {max_displacement}, stride {stride} is outside "
                         f"the tensor-core kernel's rule")
    return tc


def _fwd_cuda(f1, f2, max_displacement, stride, kernel="rule"):
    """K5 on CUDA tensors; ``kernel`` as for ``_use_tc``."""
    common.check_inputs("correlation_fwd", {"f1": f1, "f2": f2}, f1.dtype)
    n = n_displacements(max_displacement, stride)
    out = torch.empty((*f1.shape[:3], n * n), dtype=f1.dtype,
                      device=f1.device)
    if _use_tc("correlation_fwd", kernel, f1,
               (f1.data_ptr(), f2.data_ptr()), max_displacement, stride):
        _launch("correlation_fwd_tc", library().odek_correlation_fwd_tc, f1,
                f2, out, f1, max_displacement, stride)
        common.launches["correlation_fwd"] += 1
        return out
    plan = simt_plan(*f1.shape, max_displacement, stride,
                     f1.dtype)["correlation_fwd"]
    if plan.kernel == "pairs":
        _launch("correlation_fwd_pairs",
                library().odek_correlation_fwd_pairs, f1, f2, out, f1,
                max_displacement, stride, plan)
        common.launches["correlation_fwd"] += 1
    else:
        _launch("correlation_fwd", library().odek_correlation_fwd, f1, f2,
                out, f1, max_displacement, stride, plan)
    return out


def correlation_fwd(f1: torch.Tensor, f2: torch.Tensor,
                    max_displacement: int, stride: int) -> torch.Tensor:
    """K5: f1, f2 (B, H, W, C) -> (B, H, W, n*n), f1's dtype."""
    _check_nhwc_pair("correlation_fwd", f1, f2)
    if not common.use_kernel(f1):
        return correlation_fwd_plain(f1, f2, max_displacement, stride)
    return _fwd_cuda(f1, f2, max_displacement, stride)


def _bwd_cuda(name, g, f, fname, tc_ptrs, max_displacement, stride,
              kernel="rule"):
    """K6 (``name`` "correlation_bwd_f1", f = f2) or K7
    ("correlation_bwd_f2", f = f1) on CUDA tensors; ``kernel`` as for
    ``_use_tc``. The tensor-core kernels read g by element, so only the
    pointers ``tc_ptrs(f, gf)`` (K6: f2 and the gradient, K7: f1) enter
    the rule."""
    common.check_inputs(name, {"g": g, fname: f}, f.dtype)
    gf = torch.empty_like(f)
    lib = library()
    if _use_tc(name, kernel, f, tc_ptrs(f, gf), max_displacement, stride):
        _launch(f"{name}_tc", getattr(lib, f"odek_{name}_tc"), g, f, gf, f,
                max_displacement, stride)
        common.launches[name] += 1
        return gf
    plan = simt_plan(*f.shape, max_displacement, stride, f.dtype)[name]
    if plan.kernel == "pairs":
        _launch(f"{name}_pairs", getattr(lib, f"odek_{name}_pairs"), g, f,
                gf, f, max_displacement, stride, plan)
        common.launches[name] += 1
    else:
        _launch(name, getattr(lib, f"odek_{name}"), g, f, gf, f,
                max_displacement, stride, plan)
    return gf


def _bwd_f1_cuda(g, f2, max_displacement, stride, kernel="rule"):
    return _bwd_cuda("correlation_bwd_f1", g, f2, "f2",
                     lambda f, gf: (f.data_ptr(), gf.data_ptr()),
                     max_displacement, stride, kernel)


def correlation_bwd_f1(g: torch.Tensor, f2: torch.Tensor,
                       max_displacement: int, stride: int) -> torch.Tensor:
    """K6: cotangent (B, H, W, n*n) and f2 (B, H, W, C) -> grad f1."""
    n = n_displacements(max_displacement, stride)
    _check_cotangent("correlation_bwd_f1", g, f2, n)
    if not common.use_kernel(g):
        return correlation_bwd_f1_plain(g, f2, max_displacement, stride)
    return _bwd_f1_cuda(g, f2, max_displacement, stride)


def _bwd_f2_cuda(g, f1, max_displacement, stride, kernel="rule"):
    return _bwd_cuda("correlation_bwd_f2", g, f1, "f1",
                     lambda f, gf: (f.data_ptr(),), max_displacement, stride,
                     kernel)


def correlation_bwd_f2(g: torch.Tensor, f1: torch.Tensor,
                       max_displacement: int, stride: int) -> torch.Tensor:
    """K7: cotangent (B, H, W, n*n) and f1 (B, H, W, C) -> grad f2."""
    n = n_displacements(max_displacement, stride)
    _check_cotangent("correlation_bwd_f2", g, f1, n)
    if not common.use_kernel(g):
        return correlation_bwd_f2_plain(g, f1, max_displacement, stride)
    return _bwd_f2_cuda(g, f1, max_displacement, stride)


class CorrelationFn(torch.autograd.Function):
    """K5 forward; backward grad f1 = K6, grad f2 = K7."""

    @staticmethod
    def forward(ctx, f1, f2, max_displacement: int, stride: int):
        ctx.save_for_backward(f1, f2)
        ctx.geometry = (max_displacement, stride)
        return correlation_fwd(f1, f2, max_displacement, stride)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        g = g.contiguous()
        gf1 = gf2 = None
        if ctx.needs_input_grad[0]:
            gf1 = correlation_bwd_f1(g, f2, *ctx.geometry)
        if ctx.needs_input_grad[1]:
            gf2 = correlation_bwd_f2(g, f1, *ctx.geometry)
        return gf1, gf2, None, None


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                max_displacement: int = 20, stride: int = 2) -> torch.Tensor:
    """(B,H,W,C) x (B,H,W,C) -> (B,H,W,n*n) channel-mean cost volume."""
    _check_nhwc_pair("correlation", f1, f2)
    return CorrelationFn.apply(f1.contiguous(), f2.contiguous(),
                               max_displacement, stride)


# One K5, K6 or K7 kernel on CUDA tensors whatever the rule says, no
# autograd (the card tests and chip_smoke.py hold the kernels against each
# other); the tensor-core ones raise outside their rule.

def _correlation_fwd_tc(f1, f2, max_displacement, stride):
    _check_nhwc_pair("correlation_fwd", f1, f2)
    return _fwd_cuda(f1, f2, max_displacement, stride, "tc")


def _correlation_fwd_simt(f1, f2, max_displacement, stride):
    _check_nhwc_pair("correlation_fwd", f1, f2)
    return _fwd_cuda(f1, f2, max_displacement, stride, "simt")


def _correlation_bwd_f1_tc(g, f2, max_displacement, stride):
    _check_cotangent("correlation_bwd_f1", g, f2,
                     n_displacements(max_displacement, stride))
    return _bwd_f1_cuda(g, f2, max_displacement, stride, "tc")


def _correlation_bwd_f1_simt(g, f2, max_displacement, stride):
    _check_cotangent("correlation_bwd_f1", g, f2,
                     n_displacements(max_displacement, stride))
    return _bwd_f1_cuda(g, f2, max_displacement, stride, "simt")


def _correlation_bwd_f2_tc(g, f1, max_displacement, stride):
    _check_cotangent("correlation_bwd_f2", g, f1,
                     n_displacements(max_displacement, stride))
    return _bwd_f2_cuda(g, f1, max_displacement, stride, "tc")


def _correlation_bwd_f2_simt(g, f1, max_displacement, stride):
    _check_cotangent("correlation_bwd_f2", g, f1,
                     n_displacements(max_displacement, stride))
    return _bwd_f2_cuda(g, f1, max_displacement, stride, "simt")
