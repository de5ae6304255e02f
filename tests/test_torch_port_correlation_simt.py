"""The design of the SIMT K5-K7, on the CPU.

The kernels (``csrc/correlation.cu::corr_fwd_simt_kernel``,
``corr_bwd_f1_simt_kernel``, ``corr_bwd_f2_simt_kernel`` and their pair
views) cannot run here, so what they rest on is tested instead, through a
walk in Python of the same block and thread decode, with the tiles
``simt_plan`` gives:

* the parity classes (``class_axis``): cell a of a class meets cell
  a + k + i of its partner class at displacement i, every in-map window
  exactly once;
* K5's plan: every (pixel, displacement) whose window lies in the map
  computed and written by exactly one slot of a tile's micro-tiles, or of
  the pair view on maps of at most 32 cells a class, and no other one;
  K6's and K7's plans: every (pixel, channel) of the gradient stored by
  exactly one thread (K6 in fp32 and in bf16, whose threads own 8-channel
  units); all within a block's 232,448 bytes of shared memory and 256
  threads, at the highres, label, FlyingChairs and trainer shapes, every
  ragged card shape and a 1x1 map;
* the plan's refusals;
* the kernels' algorithms in plain torch, block by block: K5 (each
  written slot the mean of its cell times its partner, the rest zero)
  within 1e-6 of ``correlation_fwd_plain`` in fp64; K6 (halo rows walked
  from the first to the last, each row's pair matrix built as the kernel
  stages it, partners walked from the first to the last, one fp32
  multiply-add each) bit-equal to ``correlation_bwd_f1_plain`` on
  bf16-valued inputs and in fp32 (where a product rounds, so only the
  same order of summation is bit-equal), within 1e-6 of it in fp64, and
  within 1e-5 of the JAX package's Pallas K6 in interpret mode; K7 (halo rows walked from the
  last to the first, sources from the last to the first) bit-equal to
  ``correlation_bwd_f2_plain`` on bf16-valued inputs.
"""

import numpy as np
import pytest
import torch

from ode_rl_torch.ops.correlation import (bwd_simt_smem, class_axis,
                                          correlation_bwd_f1_plain,
                                          correlation_bwd_f2_plain,
                                          correlation_fwd_plain,
                                          fwd_simt_geometry, n_displacements,
                                          simt_plan)

SMEM_BYTES = 232_448

# (B, H, W, C, d, stride): the highres trainer's features, the S3VAE label
# features, FlyingChairs' and the FlowNetC trainers'.
MAIN_SHAPES = [(8, 40, 56, 256, 20, 2), (156, 8, 8, 256, 20, 2),
               (8, 48, 64, 256, 20, 2), (8, 8, 8, 256, 20, 2)]
# The card tests' shapes (tests/test_torch_port_cuda.py::CORR_SHAPES and
# its new SIMT rows, K6_SHAPES' maps of cells without partners) and a 1x1
# map.
CARD_SHAPES = [(2, 5, 7, 19, 2, 1), (3, 6, 4, 40, 3, 2), (2, 3, 5, 33, 4, 1),
               (1, 8, 8, 16, 4, 1), (2, 8, 8, 256, 20, 2),
               (2, 48, 64, 256, 20, 2), (2, 40, 56, 256, 20, 2),
               (2, 41, 57, 40, 20, 2), (1, 1, 1, 1, 20, 2),
               (2, 1, 1, 8, 3, 2), (2, 1, 80, 8, 3, 2)]
# Small enough to walk the kernels' algorithms block by block here: ragged
# C, H != W, stride 1 and 2, d not a multiple of the stride, d beyond the
# map, odd maps whose parity classes differ in size, and a 1x1 map.
EMULATED = [(2, 5, 7, 19, 2, 1), (3, 6, 4, 40, 3, 2), (2, 3, 5, 33, 4, 1),
            (1, 8, 8, 16, 4, 1), (2, 8, 8, 24, 20, 2), (1, 9, 11, 20, 5, 2),
            (1, 11, 13, 8, 5, 3), (1, 1, 1, 1, 20, 2)]


def _div_up(a, b):
    return -(-a // b)


def _decode(bx, stride, tiles):
    """(class axes y and x, tile row, tile column, group) of block bx, as
    the kernels decode blockIdx.x; ``tiles`` = (ytiles, xtiles, groups)."""
    ytiles, xtiles, groups = tiles
    grp = bx % groups
    bx //= groups
    xt = bx % xtiles
    bx //= xtiles
    yt = bx % ytiles
    cls = bx // ytiles
    return cls // stride, cls % stride, yt, xt, grp


# --------------------------------------------------------------------------
# K5


def _fwd_blocks(h, w, d, stride, plan):
    """Yield one dict a block of K5's tiled kernel, as
    corr_fwd_simt_kernel sees it: the class axes, the tile, the
    displacement rows and the partner rows and columns it stages."""
    n = n_displacements(d, stride)
    trows, tx, tny = plan.tile
    rows, cols = _div_up(h, stride), _div_up(w, stride)
    tiles = (_div_up(rows, trows), _div_up(cols, tx), _div_up(n, tny))
    assert plan.grid[0] == stride ** 2 * np.prod(tiles)
    for bx in range(plan.grid[0]):
        cy, cx, yt, xt, dg = _decode(bx, stride, tiles)
        ay, ax = class_axis(cy, h, d, stride), class_axis(cx, w, d, stride)
        y0, x0 = yt * trows, xt * tx
        if y0 >= ay[0] or x0 >= ax[0]:
            continue
        iy0 = dg * tny
        ny = min(tny, n - iy0)
        pr = (max(y0 + ay[2] + iy0, 0),
              min(y0 + trows - 1 + ay[2] + iy0 + ny - 1, ay[3] - 1))
        pc = (max(x0 + ax[2], 0), min(x0 + tx - 1 + ax[2] + n - 1, ax[3] - 1))
        yield dict(cy=cy, cx=cx, ay=ay, ax=ax, y0=y0, x0=x0, iy0=iy0, ny=ny,
                   pr=pr, pc=pc)


def _fwd_slots(blk, h, w, d, stride, plan):
    """Every (row, cell, partner) slot of the block's micro-tiles, one a
    thread: arrays y, x, i (the output, where the slot is written), the
    tile row r, cell column xl, partner row and column (in the partner
    class), and written (the kernel computes and writes out the slot)."""
    n = n_displacements(d, stride)
    trows, tx, tny = plan.tile
    geo = fwd_simt_geometry(tx, tny, h, w, n, stride)
    assert geo["jobs"] <= plan.threads <= 192
    nch, nxg = geo["chunks"], tx // 4
    t = np.arange(plan.threads)
    ch, xg, hr = t % nch, t // nch % nxg, t // (nch * nxg)
    (cells_y, _, ky, _), (cells_x, _, kx, _) = blk["ay"], blk["ax"]
    (pr_lo, pr_hi), (pc_lo, pc_hi) = blk["pr"], blk["pc"]
    y0, x0, iy0, ny = blk["y0"], blk["x0"], blk["iy0"], blk["ny"]
    xa = x0 + 4 * xg
    start = np.maximum(xa + kx, pc_lo) + 8 * ch
    last = np.minimum(xa + 3 + kx + n - 1, pc_hi)
    r, p, q = np.meshgrid(np.arange(trows), np.arange(4), np.arange(8),
                          indexing="ij")
    sl = (slice(None), None, None, None)
    prow = (pr_lo + hr)[sl]
    y = y0 + r
    iy = prow - y - ky
    xl = (4 * xg)[sl] + p
    pcol = start[sl] + q
    ix = pcol - (x0 + xl) - kx
    active = ((hr < pr_hi - pr_lo + 1) & (pc_hi >= pc_lo) & (xa < cells_x)
              & (start <= last))[sl]
    row_ok = (y < cells_y) & (iy >= iy0) & (iy < iy0 + ny)
    written = (active & row_ok & (x0 + xl < cells_x) & (pcol <= last[sl])
               & (ix >= 0) & (ix < n))
    full = np.broadcast_to
    shape = written.shape
    return dict(y=full(blk["cy"] + stride * y, shape),
                x=full(blk["cx"] + stride * (x0 + xl), shape),
                i=full(iy * n + ix, shape), written=written,
                r=full(r, shape), xl=full(xl, shape),
                prow=full(prow, shape), pcol=full(pcol, shape))


def _pair_slots(h, w, d, stride, plan, b):
    """Every (unit, cell, partner) slot of K5's pair view, one a thread's
    kPairQ partners: arrays unit, y, x (the cell), y2, x2 (the partner)
    and written (the pair's window lies in the map)."""
    n = n_displacements(d, stride)
    (units,) = plan.tile
    cells = _div_up(h, stride) * _div_up(w, stride)
    assert cells <= 32
    np4 = _div_up(cells, 4) * 4
    groups = np4 // 4
    per_unit = cells * groups
    assert units * per_unit <= plan.threads <= 256
    out = []
    for bx in range(plan.grid[0]):
        t = np.arange(plan.threads)
        ul, pc, qg = t // per_unit, t % per_unit // groups, t % groups
        u = bx * units + ul
        for j in range(4):
            for k in np.flatnonzero((ul < units) & (u < b * stride ** 2)):
                cls = u[k] % stride ** 2
                ay = class_axis(cls // stride, h, d, stride)
                ax = class_axis(cls % stride, w, d, stride)
                cell, part = pc[k], 4 * qg[k] + j
                if cell >= ay[0] * ax[0] or part >= ay[3] * ax[3]:
                    continue
                y = cls // stride + stride * (cell // ax[0])
                x = cls % stride + stride * (cell % ax[0])
                y2 = ay[1] + stride * (part // ax[3])
                x2 = ax[1] + stride * (part % ax[3])
                iy, ix = (y2 - y + d) // stride, (x2 - x + d) // stride
                out.append((u[k] // stride ** 2, y, x, y2, x2,
                            0 <= iy < n and 0 <= ix < n, iy * n + ix))
    return np.array(out, dtype=np.int64).reshape(-1, 7)


@pytest.mark.parametrize("shape", MAIN_SHAPES + CARD_SHAPES)
def test_k5_plan_writes_every_in_map_output_once(shape):
    """Each output whose window lies in the map is computed and written by
    exactly one slot; every other output is one of the zeros the block
    stages (tiles) or writes (pairs) first, and no slot writes it."""
    b, h, w, c, d, stride = shape
    plan = simt_plan(b, h, w, c, d, stride, torch.float32)["correlation_fwd"]
    assert plan.smem_bytes <= SMEM_BYTES
    assert 32 <= plan.threads <= 256 and plan.threads % 32 == 0
    n = n_displacements(d, stride)
    counts = np.zeros(h * w * n * n, np.int64)
    if plan.kernel == "pairs":
        assert plan.grid[1] == 1
        bb = min(b, 2)  # every unit of a sample is alike
        slots = _pair_slots(h, w, d, stride, plan._replace(
            grid=(_div_up(bb * stride ** 2, plan.tile[0]), 1)), bb)
        slots = slots[(slots[:, 0] == 0) & (slots[:, 5] == 1)]
        y, x, i = slots[:, 1], slots[:, 2], slots[:, 6]
        np.add.at(counts, (y * w + x) * n * n + i, 1)
    else:
        assert plan.grid[1] == b
        for blk in _fwd_blocks(h, w, d, stride, plan):
            s = _fwd_slots(blk, h, w, d, stride, plan)
            wr = s["written"]
            np.add.at(counts, (s["y"][wr] * w + s["x"][wr]) * n * n
                      + s["i"][wr], 1)
    y, x, iy, ix = np.unravel_index(np.arange(h * w * n * n), (h, w, n, n))
    yy, xx = y + iy * stride - d, x + ix * stride - d
    in_map = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    assert (counts[in_map] == 1).all() and (counts[~in_map] == 0).all()


def test_k5_plans_at_the_main_shapes():
    """The highres trainer's (8, 40, 56, 256), d = 20, stride 2: 20 x 28
    cells a class, tiles of 2 rows of 28 cells by 7 displacement rows, 192
    threads, two blocks an SM by shared memory. The label and trainer
    features (8 x 8: 4 x 4 cells a class) take the pair view, a unit a
    block."""
    plan = simt_plan(8, 40, 56, 256, 20, 2, torch.float32)["correlation_fwd"]
    assert plan.kernel == "tiles" and plan.tile == (2, 28, 7)
    assert plan.threads == 192 and plan.grid == (4 * 10 * 1 * 3, 8)
    assert plan.chunk == 32 and plan.smem_bytes <= SMEM_BYTES // 2 - 1024
    for b in (156, 8):
        plan = simt_plan(b, 8, 8, 256, 20, 2,
                         torch.float32)["correlation_fwd"]
        assert plan.kernel == "pairs" and plan.tile == (1,)
        assert plan.threads == 64 and plan.grid == (b * 4, 1)


def _fwd_emulated(f1, f2, d, stride):
    """K5 in fp64, block by block as the plan splits it: the tiles' slots
    (or the pair view's pairs) each the channel mean of its f1 cell times
    its partner, written where the kernel writes it; everything else
    zero."""
    b, h, w, c = f1.shape
    n = n_displacements(d, stride)
    plan = simt_plan(b, h, w, c, d, stride, torch.float32)["correlation_fwd"]
    out = torch.zeros(b, h, w, n * n, dtype=torch.float64)
    if plan.kernel == "pairs":
        s = _pair_slots(h, w, d, stride, plan, b)
        s = s[s[:, 5] == 1]
        bi, y, x, y2, x2, i = (torch.from_numpy(s[:, k])
                               for k in (0, 1, 2, 3, 4, 6))
        out[bi, y, x, i] = (f1[bi, y, x] * f2[bi, y2, x2]).sum(-1) / c
        return out
    for blk in _fwd_blocks(h, w, d, stride, plan):
        s = _fwd_slots(blk, h, w, d, stride, plan)
        wr = s["written"]
        y, x, i = (torch.from_numpy(np.ascontiguousarray(s[k][wr]))
                   for k in ("y", "x", "i"))
        y2 = torch.from_numpy(blk["ay"][1] + stride * s["prow"][wr])
        x2 = torch.from_numpy(blk["ax"][1] + stride * s["pcol"][wr])
        out[:, y, x, i] = (f1[:, y, x] * f2[:, y2, x2]).sum(-1) / c
    return out


@pytest.mark.parametrize("shape", EMULATED)
def test_k5_algorithm_matches_the_plain_version(shape):
    b, h, w, c, d, stride = shape
    rng = np.random.RandomState(17)
    f1, f2 = (torch.from_numpy(rng.randn(b, h, w, c)) for _ in range(2))
    out = _fwd_emulated(f1, f2, d, stride)
    ref = correlation_fwd_plain(f1, f2, d, stride)
    assert (out - ref).abs().max().item() <= 1e-6


# --------------------------------------------------------------------------
# K7


def _bwd_blocks(h, w, c, d, stride, plan):
    """Yield one dict a block of K7, as corr_bwd_f2_simt_kernel sees it:
    the source axes (whose partners are this f2 class), the tile, the
    channel slice and the halo's rows and columns in the map."""
    n = n_displacements(d, stride)
    ty, tx, ncg = plan.tile
    rows, cols = _div_up(h, stride), _div_up(w, stride)
    tiles = (_div_up(rows, ty), _div_up(cols, tx), _div_up(c, 16 * ncg))
    assert plan.grid[0] == stride ** 2 * np.prod(tiles)
    for bx in range(plan.grid[0]):
        qy, qx, yt, xt, sl = _decode(bx, stride, tiles)
        ay = class_axis((qy + d) % stride, h, d, stride)
        ax = class_axis((qx + d) % stride, w, d, stride)
        assert (ay[1], ax[1]) == (qy, qx)
        qy0, qx0 = yt * ty, xt * tx
        if qy0 >= ay[3] or qx0 >= ax[3]:
            continue
        py0, px0 = qy0 - ay[2] - (n - 1), qx0 - ax[2] - (n - 1)
        yield dict(ay=ay, ax=ax, qy0=qy0, qx0=qx0, c0=sl * 16 * ncg,
                   py0=py0, px0=px0, hr=(max(0, -py0),
                                         min(ty + n - 2, ay[0] - 1 - py0)),
                   hx=(max(0, -px0), min(tx + n - 2, ax[0] - 1 - px0)))


def _bwd_threads(blk, plan):
    """Per thread of the block: tile row, first tile column, channel
    group, and whether it owns outputs."""
    ty, tx, ncg = plan.tile
    t = np.arange(plan.threads)
    cg, qxg, tyl = t % ncg, t // ncg % (tx // 4), t // (ncg * (tx // 4))
    mine = ((tyl < ty) & (blk["qy0"] + tyl < blk["ay"][3])
            & (blk["qx0"] + 4 * qxg < blk["ax"][3]))
    return tyl, 4 * qxg, cg, mine


@pytest.mark.parametrize("shape", MAIN_SHAPES + CARD_SHAPES)
def test_k7_plan_stores_every_gradient_once(shape):
    b, h, w, c, d, stride = shape
    plan = simt_plan(b, h, w, c, d, stride,
                     torch.float32)["correlation_bwd_f2"]
    assert plan.grid[1] == b and plan.smem_bytes <= SMEM_BYTES
    assert 32 <= plan.threads <= 256 and plan.threads % 32 == 0
    if plan.kernel == "pairs":
        counts = np.zeros(h * w * c, np.int64)
        for unit in _bwd_pair_units(h, w, c, d, stride, plan):
            cg = unit["cg"]
            for u in range(4):
                for e in range(4):
                    ch = unit["c0"] + 4 * cg + 4 * plan.tile[0] * u + e
                    ok = unit["mine"] & (ch < c)
                    np.add.at(counts, (unit["y"][ok] * w + unit["x"][ok]) * c
                              + ch[ok], 1)
        assert (counts == 1).all()
        return
    ty, tx, ncg = plan.tile
    assert ty * (tx // 4) * ncg <= plan.threads and plan.chunk == 16 * ncg
    n = n_displacements(d, stride)
    counts = np.zeros(h * w * c, np.int64)
    p, u, e = np.meshgrid(np.arange(4), np.arange(4), np.arange(4),
                          indexing="ij")
    for blk in _bwd_blocks(h, w, c, d, stride, plan):
        tyl, q0, cg, mine = _bwd_threads(blk, plan)
        # Each owned output's sources in the map lie in the halo rows the
        # block walks and the columns its thread walks.
        hr_lo, hr_hi = blk["hr"]
        hx_lo, hx_hi = blk["hx"]
        for t in np.flatnonzero(mine):
            rows = [hr for hr in range(tyl[t], tyl[t] + n)
                    if 0 <= blk["py0"] + hr < blk["ay"][0]]
            assert all(hr_lo <= hr <= hr_hi for hr in rows)
            my_lo, my_hi = max(q0[t], hx_lo), min(q0[t] + n + 2, hx_hi)
            for pp in range(4):
                band = [hx for hx in range(q0[t] + pp, q0[t] + pp + n)
                        if 0 <= blk["px0"] + hx < blk["ax"][0]]
                assert all(my_lo <= hx <= my_hi for hx in band)
        sel = (slice(None), None, None, None)
        qxc = blk["qx0"] + q0[sel] + p
        ch = blk["c0"] + 4 * cg[sel] + 4 * ncg * u + e
        ok = mine[sel] & (qxc < blk["ax"][3]) & (ch < c)
        y = blk["ay"][1] + stride * (blk["qy0"] + tyl[sel])
        x = blk["ax"][1] + stride * qxc
        y = np.broadcast_to(y, ok.shape)[ok]
        np.add.at(counts, (y * w + x[ok]) * c + ch[ok], 1)
    assert (counts == 1).all()


def test_k7_plans_at_the_main_shapes():
    """(8, 40, 56, 256): tiles of 4 rows of 28 cells by 128 channels, 224
    threads, two blocks an SM by shared memory. The FlowNetC trainers'
    (8, 8, 8, 256): the pair view, a block a (sample, class), 256
    threads."""
    plan = simt_plan(8, 8, 8, 256, 20, 2, torch.float32)["correlation_bwd_f2"]
    assert plan.kernel == "pairs" and plan.tile == (16,)
    assert plan.threads == 256 and plan.grid == (4, 8)
    plan = simt_plan(8, 40, 56, 256, 20, 2,
                     torch.float32)["correlation_bwd_f2"]
    assert plan.kernel == "tiles" and plan.tile == (4, 28, 8)
    assert plan.threads == 224
    assert plan.grid == (4 * 5 * 1 * 2, 8) and plan.chunk == 128
    assert plan.smem_bytes <= SMEM_BYTES // 2 - 1024


def _bwd_pair_units(h, w, c, d, stride, plan):
    """Yield one dict a block of K7's pair view, as
    corr_bwd_f2_pairs_kernel sees it: the source cells (row-major), and per
    thread its output cell's map position and channel group."""
    (ncg,) = plan.tile
    cells = _div_up(h, stride) * _div_up(w, stride)
    assert cells <= 32 and cells * ncg <= plan.threads
    slices = _div_up(c, 16 * ncg)
    assert plan.grid[0] == stride ** 2 * slices
    for bx in range(plan.grid[0]):
        sl, cls = bx % slices, bx // slices
        qy, qx = cls // stride, cls % stride
        ay = class_axis((qy + d) % stride, h, d, stride)
        ax = class_axis((qx + d) % stride, w, d, stride)
        t = np.arange(plan.threads)
        cg, q = t % ncg, t // ncg
        nq = ay[3] * ax[3]
        qc = np.minimum(q, max(nq - 1, 0))
        ry, rx = (qy + d) % stride, (qx + d) % stride
        yield dict(c0=sl * 16 * ncg, cg=cg, mine=q < nq,
                   y=qy + stride * (qc // max(ax[3], 1)),
                   x=qx + stride * (qc % max(ax[3], 1)),
                   src=[(ry + stride * py, rx + stride * px)
                        for py in range(ay[0]) for px in range(ax[0])])


def _bwd_pairs_emulated(g, f1, d, stride, plan):
    """K7's pair view in fp32: each output cell walks its class's sources
    from the last to the first (row-major), adding M times f1 with M the
    cotangent at the pair's displacement, or 0 outside the window."""
    b, h, w, c = f1.shape
    n = n_displacements(d, stride)
    gf, ff = g.float(), f1.float()
    out = torch.full((b, h, w, c), float("nan"))
    for unit in _bwd_pair_units(h, w, c, d, stride, plan):
        chans = torch.arange(unit["c0"], min(unit["c0"] + 16 * plan.tile[0],
                                             c))
        for y, x in sorted({(int(y), int(x)) for y, x, m in zip(
                unit["y"], unit["x"], unit["mine"]) if m}):
            acc = torch.zeros(b, len(chans))
            for sy, sx in reversed(unit["src"]):
                iy, ix = (y - sy + d) // stride, (x - sx + d) // stride
                m = (gf[:, sy, sx, iy * n + ix] if 0 <= iy < n and 0 <= ix < n
                     else torch.zeros(b))
                acc += m[:, None] * ff[:, sy, sx, chans]
            out[:, y, x, chans] = acc / c
    return out.to(f1.dtype)


def _bwd_emulated(g, f1, d, stride):
    """K7 block by block in fp32: for each halo row from the last to the
    first, f1's channels of the halo columns in the map and the pair
    matrix M[tyl, hx, qxl] = g[source (hr, hx), iy*n + ix] over the band
    the kernel stages; then for each halo column from the last to the
    first, every output of the tile adds M times f1 (an fp32 product and
    one rounding, as the kernel's FFMA for bf16-valued inputs). Rows whose
    displacement row is out of range for a tile row add nothing to it, as
    the kernel's threads skip them."""
    b, h, w, c = f1.shape
    n = n_displacements(d, stride)
    plan = simt_plan(b, h, w, c, d, stride,
                     torch.float32)["correlation_bwd_f2"]
    if plan.kernel == "pairs":
        return _bwd_pairs_emulated(g, f1, d, stride, plan)
    ty, tx, ncg = plan.tile
    cs, hw = 16 * ncg, tx + n - 1
    gf = g.float().reshape(b, h, w, n * n)
    ff = f1.float()
    out = torch.full((b, h, w, c), float("nan"))
    for blk in _bwd_blocks(h, w, c, d, stride, plan):
        (_, qr_y, _, cells2_y), (_, qr_x, _, cells2_x) = blk["ay"], blk["ax"]
        pr_y, pr_x = (qr_y + d) % stride, (qr_x + d) % stride
        c0 = blk["c0"]
        chans = torch.arange(c0, c0 + cs)
        acc = torch.zeros(b, ty, tx, cs)
        hr_lo, hr_hi = blk["hr"]
        hx_lo, hx_hi = blk["hx"]
        q_end = min(tx, cells2_x - blk["qx0"])
        for hr in range(hr_hi, hr_lo - 1, -1):
            sy = pr_y + stride * (blk["py0"] + hr)
            fs = torch.zeros(b, hw, cs)
            m = torch.zeros(b, ty, hw, tx)
            for hx in range(hx_lo, hx_hi + 1):
                sx = pr_x + stride * (blk["px0"] + hx)
                fs[:, hx] = torch.where(chans < c,
                                        ff[:, sy, sx, chans.clamp(max=c - 1)],
                                        torch.zeros(()))
                for tyl in range(ty):
                    iy = tyl + n - 1 - hr
                    if not (0 <= iy < n and blk["qy0"] + tyl < cells2_y):
                        continue
                    for ix in range(max(0, n - 1 - hx),
                                    min(n - 1, n - 1 - hx + q_end - 1) + 1):
                        m[:, tyl, hx, hx + ix - (n - 1)] = gf[:, sy, sx,
                                                              iy * n + ix]
            for hx in range(hx_hi, hx_lo - 1, -1):
                acc += m[:, :, hx, :, None] * fs[:, None, None, hx]
        for tyl in range(ty):
            qy = blk["qy0"] + tyl
            for qxl in range(q_end):
                if qy >= cells2_y:
                    continue
                y, x = qr_y + stride * qy, qr_x + stride * (blk["qx0"] + qxl)
                keep = chans < c
                out[:, y, x, chans[keep]] = acc[:, tyl, qxl, keep] / c
    return out.to(f1.dtype)


@pytest.mark.parametrize("shape", EMULATED)
def test_k7_algorithm_is_bit_equal_to_the_plain_version_in_bf16(shape):
    b, h, w, c, d, stride = shape
    n = n_displacements(d, stride)
    rng = np.random.RandomState(23)
    g = torch.from_numpy(rng.randn(b, h, w, n * n)).to(torch.bfloat16)
    f1 = torch.from_numpy(rng.randn(b, h, w, c)).to(torch.bfloat16)
    out = _bwd_emulated(g, f1, d, stride)
    ref = correlation_bwd_f2_plain(g, f1, d, stride)
    assert out.dtype == ref.dtype == torch.bfloat16
    assert torch.equal(out, ref)


# --------------------------------------------------------------------------
# K6


def _bwd_f1_blocks(h, w, c, d, stride, plan):
    """Yield one dict a block of K6, as corr_bwd_f1_simt_kernel sees it:
    the f1 class axes, the tile and its rows and columns in the map, the
    channel slice, the halo's origin in the partner class and its rows and
    columns that some tile cell meets in the map."""
    n = n_displacements(d, stride)
    ty, tx, ncg = plan.tile
    rows, cols = _div_up(h, stride), _div_up(w, stride)
    tiles = (_div_up(rows, ty), _div_up(cols, tx), _div_up(c, 16 * ncg))
    assert plan.grid[0] == stride ** 2 * np.prod(tiles)
    for bx in range(plan.grid[0]):
        cy, cx, yt, xt, sl = _decode(bx, stride, tiles)
        ay, ax = class_axis(cy, h, d, stride), class_axis(cx, w, d, stride)
        qy0, qx0 = yt * ty, xt * tx
        if qy0 >= ay[0] or qx0 >= ax[0]:
            continue
        nrows, q_end = min(ty, ay[0] - qy0), min(tx, ax[0] - qx0)
        py0, px0 = qy0 + ay[2], qx0 + ax[2]
        yield dict(cy=cy, cx=cx, ay=ay, ax=ax, qy0=qy0, qx0=qx0,
                   rows=nrows, q_end=q_end, c0=sl * 16 * ncg, py0=py0,
                   px0=px0, hr=(max(0, -py0),
                                min(nrows + n - 2, ay[3] - 1 - py0)),
                   hx=(max(0, -px0), min(q_end + n - 2, ax[3] - 1 - px0)))


def _bwd_f1_threads(blk, plan):
    """Per thread of a K6 block: tile row, first tile column, channel
    group, and whether it owns outputs."""
    ty, tx, ncg = plan.tile
    t = np.arange(plan.threads)
    cg, qxg, tyl = t % ncg, t // ncg % (tx // 4), t // (ncg * (tx // 4))
    mine = (tyl < blk["rows"]) & (4 * qxg < blk["q_end"])
    return tyl, 4 * qxg, cg, mine


def _unit(dtype):
    """Channels a K6 thread reads and stores together: one 16-byte unit."""
    return 16 // torch.tensor([], dtype=dtype).element_size()


def _bwd_f1_pair_units(h, w, c, d, stride, plan):
    """Yield one dict a block of K6's pair view, as
    corr_bwd_f1_pairs_kernel sees it: the partner cells (row-major), and
    per thread its output cell's map position and channel group."""
    (ncg,) = plan.tile
    cells = _div_up(h, stride) * _div_up(w, stride)
    assert cells <= 32 and cells * ncg <= plan.threads
    slices = _div_up(c, 16 * ncg)
    assert plan.grid[0] == stride ** 2 * slices
    for bx in range(plan.grid[0]):
        sl, cls = bx % slices, bx // slices
        cy, cx = cls // stride, cls % stride
        ay, ax = class_axis(cy, h, d, stride), class_axis(cx, w, d, stride)
        t = np.arange(plan.threads)
        cg, p = t % ncg, t // ncg
        npix = ay[0] * ax[0]
        pc = np.minimum(p, max(npix - 1, 0))
        yield dict(c0=sl * 16 * ncg, cg=cg, mine=p < npix,
                   y=cy + stride * (pc // max(ax[0], 1)),
                   x=cx + stride * (pc % max(ax[0], 1)),
                   partners=[(ay[1] + stride * qy, ax[1] + stride * qx)
                             for qy in range(ay[3]) for qx in range(ax[3])])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MAIN_SHAPES + CARD_SHAPES)
def test_k6_plan_stores_every_gradient_once(shape, dtype):
    """Every (pixel, channel) of grad f1 is stored by exactly one thread,
    zeros included (cells with no partner in the map); each owned output's
    in-map partners lie in the halo rows its block walks and the columns
    its thread walks."""
    b, h, w, c, d, stride = shape
    n = n_displacements(d, stride)
    plan = simt_plan(b, h, w, c, d, stride, dtype)["correlation_bwd_f1"]
    assert plan.grid[1] == b and plan.smem_bytes <= SMEM_BYTES
    assert 32 <= plan.threads <= 256 and plan.threads % 32 == 0
    counts = np.zeros(h * w * c, np.int64)
    k = _unit(dtype)
    if plan.kernel == "pairs":
        assert plan.threads <= 128
        for unit in _bwd_f1_pair_units(h, w, c, d, stride, plan):
            for u in range(16 // k):
                for e in range(k):
                    ch = unit["c0"] + k * unit["cg"] + k * plan.tile[0] * u + e
                    ok = unit["mine"] & (ch < c)
                    np.add.at(counts, (unit["y"][ok] * w + unit["x"][ok]) * c
                              + ch[ok], 1)
        assert (counts == 1).all()
        return
    ty, tx, ncg = plan.tile
    assert ty * (tx // 4) * ncg <= plan.threads and plan.chunk == 16 * ncg
    assert plan.smem_bytes == bwd_simt_smem(
        ty, tx, ncg, n, torch.tensor([], dtype=dtype).element_size())
    p, u, e = np.meshgrid(np.arange(4), np.arange(16 // k), np.arange(k),
                          indexing="ij")
    for blk in _bwd_f1_blocks(h, w, c, d, stride, plan):
        tyl, q0, cg, mine = _bwd_f1_threads(blk, plan)
        (_, _, ky, cells2_y), (_, _, kx, cells2_x) = blk["ay"], blk["ax"]
        hr_lo, hr_hi = blk["hr"]
        hx_lo, hx_hi = blk["hx"]
        for t in np.flatnonzero(mine):
            qy = blk["qy0"] + tyl[t]
            rows = [tyl[t] + iy for iy in range(n)
                    if 0 <= qy + ky + iy < cells2_y]
            assert all(hr_lo <= hr <= hr_hi for hr in rows)
            my_lo, my_hi = max(q0[t], hx_lo), min(q0[t] + n + 2, hx_hi)
            for pp in range(4):
                if q0[t] + pp >= blk["q_end"]:
                    continue
                qx = blk["qx0"] + q0[t] + pp
                band = [q0[t] + pp + ix for ix in range(n)
                        if 0 <= qx + kx + ix < cells2_x]
                assert all(my_lo <= hx <= my_hi for hx in band)
        sel = (slice(None), None, None, None)
        qxl = q0[sel] + p
        ch = blk["c0"] + k * cg[sel] + k * ncg * u + e
        ok = mine[sel] & (qxl < blk["q_end"]) & (ch < c)
        y = blk["cy"] + stride * (blk["qy0"] + tyl[sel])
        x = blk["cx"] + stride * (blk["qx0"] + qxl)
        y = np.broadcast_to(y, ok.shape)[ok]
        np.add.at(counts, (y * w + x[ok]) * c + ch[ok], 1)
    assert (counts == 1).all()


def test_k6_plans_at_the_main_shapes():
    """(8, 40, 56, 256) and FlyingChairs' (8, 48, 64, 256): tiles of 4
    rows of 16 cells by all 256 channels (one slice), 256 threads, two
    blocks an SM by shared memory; bf16 stages half the feature bytes.
    The trainers' (8, 8, 8, 256): the pair view, a block a (sample, class,
    128 channels) of 128 threads."""
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.tensor([], dtype=dtype).element_size()
        for shape, xtiles in (((8, 40, 56, 256), 2), ((8, 48, 64, 256), 2)):
            plan = simt_plan(*shape, 20, 2, dtype)["correlation_bwd_f1"]
            rows = _div_up(shape[1], 2)
            assert plan.kernel == "tiles" and plan.tile == (4, 16, 16)
            assert plan.threads == 256 and plan.chunk == 256
            assert plan.grid == (4 * _div_up(rows, 4) * xtiles, 8)
            assert plan.smem_bytes == 2 * (36 * 256 * size + 4 * 4 * 36 * 16)
            assert plan.smem_bytes <= SMEM_BYTES // 2 - 1024
    plan = simt_plan(8, 8, 8, 256, 20, 2, torch.float32)["correlation_bwd_f1"]
    assert plan.kernel == "pairs" and plan.tile == (8,)
    assert plan.threads == 128 and plan.grid == (4 * 2, 8)


def _bwd_f1_pairs_emulated(g, f2, d, stride, plan):
    """K6's pair view: each output cell walks its class's partners from the
    first to the last (row-major), adding M times f2 with M the cotangent
    at the pair's displacement, or 0 outside the window; in the inputs'
    accumulation dtype (fp32, fp64 for fp64)."""
    b, h, w, c = f2.shape
    n = n_displacements(d, stride)
    acc_t = torch.promote_types(f2.dtype, torch.float32)
    gf, ff = g.to(acc_t), f2.to(acc_t)
    out = torch.full((b, h, w, c), float("nan"), dtype=acc_t)
    for unit in _bwd_f1_pair_units(h, w, c, d, stride, plan):
        chans = torch.arange(unit["c0"], min(unit["c0"] + 16 * plan.tile[0],
                                             c))
        for y, x in sorted({(int(y), int(x)) for y, x, m in zip(
                unit["y"], unit["x"], unit["mine"]) if m}):
            acc = torch.zeros(b, len(chans), dtype=acc_t)
            for qy, qx in unit["partners"]:
                iy, ix = (qy - y + d) // stride, (qx - x + d) // stride
                m = (gf[:, y, x, iy * n + ix] if 0 <= iy < n and 0 <= ix < n
                     else torch.zeros(b, dtype=acc_t))
                acc += m[:, None] * ff[:, qy, qx, chans]
            out[:, y, x, chans] = acc / c
    return out.to(f2.dtype)


def _bwd_f1_emulated(g, f2, d, stride):
    """K6 block by block, with the plan of f2's dtype (fp64 takes fp32's),
    in the inputs' accumulation dtype: for each halo row from the first to
    the last, f2's channels of the halo columns in the map and the pair
    matrix M[tyl, hx, qxl] = g[tile cell (tyl, qxl), iy*n + ix] over the
    band the kernel stages; then for each halo column from the first to
    the last, every output of the tile adds M times f2 (one product and
    one rounding, as the kernel's FFMA for bf16-valued inputs). Tile rows
    whose displacement row is out of range for a halo row add nothing from
    it, as the kernel's threads skip it. Cells with no partner stay 0."""
    b, h, w, c = f2.shape
    n = n_displacements(d, stride)
    plan_t = torch.bfloat16 if f2.dtype == torch.bfloat16 else torch.float32
    plan = simt_plan(b, h, w, c, d, stride, plan_t)["correlation_bwd_f1"]
    if plan.kernel == "pairs":
        return _bwd_f1_pairs_emulated(g, f2, d, stride, plan)
    ty, tx, ncg = plan.tile
    cs, hw = 16 * ncg, tx + n - 1
    acc_t = torch.promote_types(f2.dtype, torch.float32)
    gf, ff = g.to(acc_t), f2.to(acc_t)
    out = torch.full((b, h, w, c), float("nan"), dtype=acc_t)
    for blk in _bwd_f1_blocks(h, w, c, d, stride, plan):
        (_, r2y, _, _), (_, r2x, _, _) = blk["ay"], blk["ax"]
        chans = torch.arange(blk["c0"], blk["c0"] + cs)
        acc = torch.zeros(b, ty, tx, cs, dtype=acc_t)
        hr_lo, hr_hi = blk["hr"]
        hx_lo, hx_hi = blk["hx"]
        for hr in range(hr_lo, hr_hi + 1):
            sy = r2y + stride * (blk["py0"] + hr)
            fs = torch.zeros(b, hw, cs, dtype=acc_t)
            m = torch.zeros(b, ty, hw, tx, dtype=acc_t)
            for hx in range(hx_lo, hx_hi + 1):
                sx = r2x + stride * (blk["px0"] + hx)
                fs[:, hx] = torch.where(chans < c,
                                        ff[:, sy, sx, chans.clamp(max=c - 1)],
                                        torch.zeros((), dtype=acc_t))
            for tyl in range(blk["rows"]):
                iy = hr - tyl
                if not 0 <= iy < n:
                    continue
                y = blk["cy"] + stride * (blk["qy0"] + tyl)
                for qxl in range(blk["q_end"]):
                    x = blk["cx"] + stride * (blk["qx0"] + qxl)
                    for ix in range(max(0, hx_lo - qxl),
                                    min(n - 1, hx_hi - qxl) + 1):
                        m[:, tyl, qxl + ix, qxl] = gf[:, y, x, iy * n + ix]
            live = torch.tensor([0 <= hr - tyl < n for tyl in range(ty)])
            for hx in range(hx_lo, hx_hi + 1):
                acc += torch.where(live[None, :, None, None],
                                   m[:, :, hx, :, None] * fs[:, None, None,
                                                             hx],
                                   torch.zeros((), dtype=acc_t))
        keep = chans < c
        for tyl in range(blk["rows"]):
            y = blk["cy"] + stride * (blk["qy0"] + tyl)
            for qxl in range(blk["q_end"]):
                x = blk["cx"] + stride * (blk["qx0"] + qxl)
                out[:, y, x, chans[keep]] = acc[:, tyl, qxl, keep] / c
    return out.to(f2.dtype)


def _k6_inputs(shape, seed, dtype):
    b, h, w, c, d, stride = shape
    n = n_displacements(d, stride)
    rng = np.random.RandomState(seed)
    g = torch.from_numpy(rng.randn(b, h, w, n * n)).to(dtype)
    f2 = torch.from_numpy(rng.randn(b, h, w, c)).to(dtype)
    return g, f2, d, stride


@pytest.mark.parametrize("shape", EMULATED)
def test_k6_algorithm_is_bit_equal_to_the_plain_version_in_bf16(shape):
    g, f2, d, stride = _k6_inputs(shape, 29, torch.bfloat16)
    out = _bwd_f1_emulated(g, f2, d, stride)
    ref = correlation_bwd_f1_plain(g, f2, d, stride)
    assert out.dtype == ref.dtype == torch.bfloat16
    assert torch.equal(out, ref)


@pytest.mark.parametrize("shape", EMULATED)
def test_k6_order_of_summation_is_the_plain_versions(shape):
    """In fp32 a product rounds, and the emulation rounds it as the plain
    version does, so the two are bit-equal only if every output adds its
    displacements in the same order. (A bf16 result rounds fp32 sums to 8
    bits, so another order shows there only near a rounding boundary.)"""
    g, f2, d, stride = _k6_inputs(shape, 41, torch.float32)
    assert torch.equal(_bwd_f1_emulated(g, f2, d, stride),
                       correlation_bwd_f1_plain(g, f2, d, stride))


@pytest.mark.parametrize("shape", EMULATED)
def test_k6_algorithm_matches_the_plain_version_in_fp64(shape):
    g, f2, d, stride = _k6_inputs(shape, 31, torch.float64)
    out = _bwd_f1_emulated(g, f2, d, stride)
    ref = correlation_bwd_f1_plain(g, f2, d, stride)
    assert (out - ref).abs().max().item() <= 1e-6


@pytest.mark.parametrize("shape", [EMULATED[0], EMULATED[1]])
def test_k6_algorithm_matches_the_pallas_kernel(shape):
    """In fp32 against the JAX package's K6 (``_bwd_f1_kernel`` through
    ``_correlation_bwd_pallas`` in interpret mode, as
    tests/test_torch_port_flow_ops.py runs the Pallas path)."""
    import jax.numpy as jnp

    from ode_rl_tpu.ops.correlation import _correlation_bwd_pallas

    g, f2, d, stride = _k6_inputs(shape, 37, torch.float32)
    out = _bwd_f1_emulated(g, f2, d, stride)
    f1 = jnp.zeros(f2.shape, jnp.float32)
    ref, _ = _correlation_bwd_pallas(f1, jnp.asarray(f2.numpy()),
                                     jnp.asarray(g.numpy()), d, stride,
                                     interpret=True)
    assert out.dtype == torch.float32
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-5


# --------------------------------------------------------------------------
# The classes and the plan's refusals


@pytest.mark.parametrize("size,d,stride", [(40, 20, 2), (41, 20, 2),
                                           (7, 3, 2), (11, 5, 3), (5, 2, 1),
                                           (1, 20, 2), (3, 0, 4)])
def test_parity_classes_pair_every_in_map_window_once(size, d, stride):
    n = n_displacements(d, stride)
    found = set()
    for r in range(stride):
        cells, r2, k, cells2 = class_axis(r, size, d, stride)
        assert cells == len(range(r, size, stride))
        for a in range(cells):
            for i in range(n):
                b = a + k + i
                if 0 <= b < cells2:
                    found.add((r + stride * a, i, r2 + stride * b))
    want = {(y, i, y + i * stride - d) for y in range(size) for i in range(n)
            if 0 <= y + i * stride - d < size}
    assert found == want


@pytest.mark.parametrize("args", [
    (1, 8, 8, 16, 20, 2, torch.float16),      # no kernel for fp16
    (70_000, 8, 8, 16, 20, 2, torch.float32),  # grid.y holds 65,535
    (1, 8, 8, 16, 5000, 1, torch.float32),     # a row of 10,001
    (1, 0, 8, 16, 20, 2, torch.float32),       # an empty map
    (1, 8, 8, 0, 20, 2, torch.float32),        # no channels
])
def test_simt_plan_refuses_what_the_kernels_cannot_index(args):
    with pytest.raises(ValueError):
        simt_plan(*args)
