"""3x3 stride-1 SAME conv of the ODE field: kernels K1 and K2.

Counterpart of ``ode_rl_tpu/ops/conv3x3.py``. NHWC x HWIO -> NHWC, with
the weights handed to the kernels as ``kernel.reshape(9 * Cin, Cout)``.

* K1 ``conv3x3_fwd`` (``csrc/conv3x3.cu``): the implicit-im2col GEMM,
  fp32 accumulation, output in the input dtype, or in fp32 from bf16
  inputs (``out_dtype``: the column-parallel dx partials of a 'model'
  axis, summed across ranks before their one rounding). Its plain version
  is ``F.conv2d`` (of the values in fp32 for an fp32 output). On the card
  it takes one of two kernels by ``uses_tensor_cores``: the tensor-core
  kernel (bf16 in, bf16 or fp32 out; TMA halo tiles, weights resident in
  shared memory, wgmma over column blocks of ``tc_nt`` output channels:
  64, 32 or 16) or the SIMT kernel (fp32 FMA; everything else,
  fp32 included, so fp32 stays strict fp32). The SIMT kernel gives a
  block a 16-column strip of an image, a run of its rows and 16 or 32
  output channels, keeps the block's weights resident for the run and
  brings the input a halo row at a time into a ring, the next rows
  loading under the products; each thread 4 pixels x 8 channels, a row's
  products split over up to 16 thread groups and added in a fixed order;
  ``simt_plan`` sizes the grid to one wave.
* K2 ``conv3x3_wgrad``: dW (9*Cin, Cout) = patches^T . g in fp32, split
  over pixels with a fixed-order reduction. Its plain version builds the 9
  shifted patches, as the Pallas kernel does, and multiplies. On the card
  it takes one of two kernels by ``wgrad_uses_tensor_cores``: the
  tensor-core kernel (bf16, Cin in multiples of 64 and Cout of 32; TMA
  halo and cotangent tiles, wgmma over pixels in blocks of 64 or 32
  output channels, one cooperative launch that sums its partials after a
  grid sync) or the SIMT kernel (everything else, fp32 included): a
  block a 64 x 64, 128 x 64 or 64 x 128 tile of dW (each thread 8 x 8)
  and a run of pixels staged in 16-pixel stages, ``wgrad_simt_plan``
  sizing the runs so that every block is resident, and the same
  cooperative launch adding the partials in split order after a grid
  sync.

On an H100 80GB HBM3 at 700 W, TF32 off, ``python -m
ode_rl_torch.simt_conv_times`` (PERF.md §6) reads, in device µs a call:
at the recipe's fp32 (4, 16, 16, 64) -> 64 the SIMT K1 7.5 forward and as
dx (cuDNN's fp32 conv 24.0) and the SIMT K2 8 (cuDNN's weight gradient
16.3), against a 1.13 µs FMA bound; at the Vid-ODE field's (4, 32, 32)
128 -> 64 / 64 -> 128 / 64 -> 64 K1 31 / 31 / 18 (cuDNN 40 / 36 / 26)
and K2 23 / 23 / 16.5 (cuDNN 24.8 / 24.8 / 20.9); at fp32 B = 128 K1
108 and K2 80-84 (cuDNN 84 and 112). Both SIMT kernels are on by the
rules above for every fp32 call: the port keeps fp32 in strict fp32, off
the tensor cores.

``Conv3x3Fn`` has the backward of ``_conv3x3_bwd``: dx is K1 on the
cotangent with spatially flipped, channel-transposed weights, dw is K2
cast to the weight dtype. The bias is added outside, in the input dtype.

Both take a ``halo`` operand (B, 2, W, Cin) in x's dtype: row 0 the row
above x's first row, row 1 the row below its last (zeros past the
frame). The conv is then SAME along W and takes its H neighbours from the
halo instead of zero padding, and the output has x's H rows: a 'space'
rank's conv over its own rows (parallel/sp.py), with no concatenated
copy and no tiles over the neighbours' rows. Every route takes it; the
rules are those without a halo.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ode_rl_torch.ops import common
from ode_rl_torch.ops._build import library

def _shape_nhwc(name: str, x: torch.Tensor) -> tuple[int, int, int, int]:
    if x.ndim != 4:
        raise ValueError(f"{name}: expected NHWC (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    return tuple(x.shape)


def _with_halo(x: torch.Tensor, halo: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """x's rows with the halo's row 0 above and row 1 below (the plain
    versions' tile); x itself without a halo."""
    if halo is None:
        return x
    return torch.cat([halo[:, :1].to(x.dtype), x, halo[:, 1:].to(x.dtype)],
                     dim=1)


def conv3x3_fwd_plain(x: torch.Tensor, w2d: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None,
                      halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.conv2d`` in x's dtype, or of the values in ``out_dtype`` (fp32
    from bf16: the products are exact in fp32); with a ``halo``, of x's
    rows between the halo's, padded along W only."""
    if out_dtype is not None and out_dtype != x.dtype:
        x = x.to(_out_dtype(x.dtype, out_dtype))
    b, h, w, cin = x.shape
    cout = w2d.shape[1]
    w_oihw = w2d.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    out = F.conv2d(_with_halo(x, halo).permute(0, 3, 1, 2),
                   w_oihw.to(x.dtype), padding=1 if halo is None else (0, 1))
    return out.permute(0, 2, 3, 1).contiguous()


# The tensor-core K1: output tiles 8 rows high of one image, and the
# shared memory a block may have on the H100 less 64 bytes for the kernel's
# static barriers. Mirrors csrc/conv3x3.cu::tc_plan.
_TC_TILE_ROWS = 8
_TC_SMEM_LIMIT = 232_448 - 64


def _round_1k(n: int) -> int:
    return -(-n // 1024) * 1024


def _tc_tile_width(w: int) -> int:
    """Width of an output tile: the image's width rounded up to 8, 16 or
    32 (a 16-wide map is tiled 8 x 16)."""
    return 8 if w <= 8 else 16 if w <= 16 else 32


def _tc_smem_bytes(cin: int, cout: int, w: int,
                   out_dtype: torch.dtype = torch.bfloat16,
                   nt: Optional[int] = None, halo: bool = False) -> int:
    """Shared memory of one tensor-core K1 block: the weights in column
    blocks of ``nt`` channels (``tc_nt``'s by default), two halo stages in
    channel chunks of 64, 32 or 16 (with a ``halo`` operand each chunk row
    padded to 128 bytes), two 8 x 8 x NT output staging buffers of
    ``out_dtype`` (fp32 doubles them), each region 1 KB aligned, and 1 KB
    to align the base. Mirrors csrc/conv3x3.cu::tc_plan_at."""
    tw = _tc_tile_width(w)
    nt = nt or tc_nt(cout, cin, w, out_dtype, halo)
    cw = 64 if cin % 64 == 0 else 32 if cin % 32 == 0 else 16
    pitch = (tw + 2) * cw * 2
    if halo:
        pitch = -(-pitch // 128) * 128
    weights = (cout // nt) * _round_1k(9 * cin * nt * 2)
    stage = (cin // cw) * _round_1k((_TC_TILE_ROWS + 2) * pitch)
    staging = _round_1k(64 * nt * out_dtype.itemsize)
    return weights + 2 * stage + 2 * staging + 1024


@functools.lru_cache(maxsize=256)  # on every launch's host path
def tc_nt(cout: int, cin: int, w: int,
          out_dtype: torch.dtype = torch.bfloat16, halo: bool = False) -> int:
    """Output channels of a tensor-core K1 column block: 64 where Cout % 64
    == 0; else 32 where Cout % 32 == 0 and that plan fits a block's shared
    memory (a 'model' rank's Cout 32 slice takes one 32-channel block, so
    the halo is read once and one epilogue stores it); else 16, the plan
    every such call took before, so no call leaves the tensor cores.
    Mirrors csrc/conv3x3.cu::tc_plan."""
    if cout % 64 == 0:
        return 64
    if cout % 32 == 0 and _tc_smem_bytes(cin, cout, w, out_dtype, 32,
                                         halo) <= _TC_SMEM_LIMIT:
        return 32
    return 16


def uses_tensor_cores(dtype: torch.dtype, cin: int, cout: int, w: int,
                      out_dtype: Optional[torch.dtype] = None) -> bool:
    """The rule that sends a K1 call on the card to the tensor-core kernel:
    bf16 in, bf16 or fp32 out (``out_dtype``, the input's by default),
    Cin % 16 == 0 (a k16 step, and TMA's 16-byte strides), Cout % 16 == 0
    and Cout <= 256 (wgmma's N), and the resident weights, two halo stages
    and the output staging of ``tc_nt``'s plan within a block's shared
    memory (so the rule depends on W through the tile width, and on the
    output's dtype). Every
    other call takes the SIMT kernel. fp32 in stays on SIMT: the tensor
    cores would round it to TF32."""
    out_dtype = out_dtype or dtype
    return (dtype == torch.bfloat16
            and out_dtype in (torch.bfloat16, torch.float32)
            and cin % 16 == 0 and cout % 16 == 0 and cout <= 256
            and _tc_smem_bytes(cin, cout, w, out_dtype) <= _TC_SMEM_LIMIT)


def _out_dtype(dtype: torch.dtype, out_dtype: Optional[torch.dtype]
               ) -> torch.dtype:
    """K1's output dtype: the input's, or fp32 from bf16."""
    if out_dtype is None or out_dtype == dtype:
        return dtype
    if dtype == torch.bfloat16 and out_dtype == torch.float32:
        return out_dtype
    raise TypeError(f"conv3x3_fwd: no {out_dtype} output from {dtype} "
                    "inputs (the input's dtype, or fp32 from bf16)")


# The SIMT K1 (csrc/conv3x3.cu::conv3x3_fwd_simt_kernel): 16 groups of 16
# threads; SK of them share one output row's products and 16 / SK rows (a
# step) go at once; a strip is this many output columns. The H100's
# shared memory: a block's dynamic share, and an SM's, of which each
# resident block takes 1 KB more.
_SIMT_GROUPS = 16
_SIMT_TILE_W = 16
_SIMT_MAX_SMEM = 232_448
_SM_SMEM = 233_472
# Blocks an SM holds at most: 256 threads of at most 128 registers
# (__launch_bounds__(256, 2)), for K1 and K2 alike.
_SIMT_BLOCKS_PER_SM = 2


def simt_split(cin: int) -> int:
    """SK: the largest power of two at most min(16, quads), quads =
    ceil(min(Cin, 64) / 4) channel quads (of a slab's channels).
    Mirrors csrc/conv3x3.cu::simt_split."""
    quads = -(-min(cin, 64) // 4)
    sk = 1
    while sk * 2 <= min(quads, _SIMT_GROUPS):
        sk *= 2
    return sk


def _simt_halo_stride(cs: int) -> int:
    """Floats between two staged halo pixels: the slab's channels rounded
    up to 4, then to 8 mod 32 (bank groups). Mirrors
    csrc/conv3x3.cu::simt_halo_stride."""
    cc4 = -(-cs // 4) * 4
    return cc4 + (8 - cc4) % 32


def simt_smem_bytes(cs: int, bn: int) -> int:
    """Shared memory of one SIMT K1 block over a slab of ``cs`` input
    channels and ``bn`` output channels: the resident weights [9 * cc4][bn],
    the ring of 2 * SR + 2 halo rows of 18 pixels, and the 8 group pairs'
    sums [8][16][bn] (none at SK = 1). Mirrors
    csrc/conv3x3.cu::simt_smem_bytes."""
    sk = simt_split(cs)
    sr = _SIMT_GROUPS // sk
    return 4 * (9 * -(-cs // 4) * 4 * bn
                + (2 * sr + 2) * (_SIMT_TILE_W + 2) * _simt_halo_stride(cs)
                + (_SIMT_GROUPS // 2 * _SIMT_TILE_W * bn if sk > 1 else 0))


def simt_slab(cin: int, bn: int) -> int:
    """Input channels a SIMT K1 launch takes: all of Cin where its block
    fits the 227 KB a block may have, else the fewest equal slabs, in
    multiples of 4, that fit (one launch each, adding in order). Mirrors
    csrc/conv3x3.cu::simt_slab."""
    n = 1
    while True:
        cs = min(-(-cin // (4 * n)) * 4, cin)
        if cs <= 4 or simt_smem_bytes(cs, bn) <= _SIMT_MAX_SMEM:
            return cs
        n += 1


@functools.lru_cache(maxsize=256)
def simt_plan(b: int, h: int, w: int, cin: int, cout: int,
              sms: int) -> tuple[int, int, int]:
    """(output channels a block BN, row steps a block R, blocks) of a SIMT
    K1 call; every shape has one. Block = ((image * strips + strip) * runs
    + run) * tiles + tile: a 16-column strip of an image, a run of R steps
    of 16 / simt_split rows (the last run of a strip shorter), a tile of
    BN output channels. BN is 32 where Cout > 16 and the map is at least
    16 wide (each thread 4 pixels x 8 channels, the halo read once a
    32-channel tile), else 16 (narrower maps fill a strip's row in part,
    and a block's weights are then most of its work). A run
    stages the block's weights once, so R is the fewest steps that put
    every block in one wave: the (strip step, tile) items over the blocks
    the card holds at once (two an SM where the shared memory allows, else
    one). On an H100 80GB HBM3 (700 W) that R and BN were the fastest, or
    within 3% of it, of R 1 to 32 at BN 16 and 32 at every shape of
    ``simt_conv_times --sweep`` (PERF.md §6). With more than one slab
    (simt_slab) the blocks are those of the first. Mirrors
    csrc/conv3x3.cu::odek_conv3x3_fwd."""
    bn = 32 if cout > 16 and w >= _SIMT_TILE_W else 16
    cs = simt_slab(cin, bn)
    per_sm = min(_SIMT_BLOCKS_PER_SM,
                 _SM_SMEM // (simt_smem_bytes(cs, bn) + 1024))
    steps = -(-h // (_SIMT_GROUPS // simt_split(cs)))
    images = b * -(-w // _SIMT_TILE_W)
    tiles = -(-cout // bn)
    rows = min(steps, max(1, -(-(images * steps * tiles) // (per_sm * sms))))
    return bn, rows, images * -(-steps // rows) * tiles


def _check_k1(x: torch.Tensor, w2d: torch.Tensor,
              halo: Optional[torch.Tensor] = None) -> tuple:
    b, h, w, cin = _shape_nhwc("conv3x3_fwd", x)
    if w2d.ndim != 2 or w2d.shape[0] != 9 * cin:
        raise ValueError(f"conv3x3_fwd: weights {tuple(w2d.shape)} do not "
                         f"match (9*{cin}, Cout)")
    _check_halo("conv3x3_fwd", x, halo)
    return b, h, w, cin, w2d.shape[1]


def _check_halo(name: str, x: torch.Tensor,
                halo: Optional[torch.Tensor]) -> None:
    """A halo is (B, 2, W, Cin) of x's dtype."""
    if halo is None:
        return
    b, _, w, cin = x.shape
    if tuple(halo.shape) != (b, 2, w, cin):
        raise ValueError(f"{name}: halo {tuple(halo.shape)} is not "
                         f"(B, 2, W, Cin) = {(b, 2, w, cin)}")
    if halo.dtype != x.dtype:
        raise TypeError(f"{name}: halo is {halo.dtype}, x {x.dtype}")


def _inputs(x: torch.Tensor, halo: Optional[torch.Tensor], **more) -> dict:
    """The tensors a launch reads, for ``common.check_inputs``."""
    return {"x": x, **({} if halo is None else {"halo": halo}), **more}


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _count_halo(name: str, x: torch.Tensor,
                halo: Optional[torch.Tensor]) -> None:
    if halo is not None:
        common.launches[f"{name}_halo"] += 1
        common.halo_heights.add(x.shape[1])


def conv3x3_fwd(x: torch.Tensor, w2d: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None,
                halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: (B, H, W, Cin) . (9*Cin, Cout) -> (B, H, W, Cout) in x's dtype,
    or in fp32 from bf16 inputs (``out_dtype``): the fp32 sums, unrounded.
    bf16 in, fp32 out takes the tensor cores by ``uses_tensor_cores``;
    outside that rule, the fp32 SIMT kernel on the inputs' values in fp32
    (exact), which sums the same products. ``halo``: the rows above and
    below x (module docstring)."""
    _, _, w, cin, cout = _check_k1(x, w2d, halo)
    out_dtype = _out_dtype(x.dtype, out_dtype)
    if not common.use_kernel(x):
        return conv3x3_fwd_plain(x, w2d, out_dtype, halo)
    common.check_inputs("conv3x3_fwd", _inputs(x, halo, w=w2d), x.dtype)
    if uses_tensor_cores(x.dtype, cin, cout, w, out_dtype):
        return _launch_tc(x, w2d, out_dtype, halo)
    if out_dtype != x.dtype:
        return _launch_simt(x.to(out_dtype), w2d.to(out_dtype),
                            None if halo is None else halo.to(out_dtype))
    return _launch_simt(x, w2d, halo)


def _conv3x3_fwd_simt(x: torch.Tensor, w2d: torch.Tensor,
                      halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1's SIMT kernel on CUDA tensors, whatever the rule says (the card
    tests and chip_smoke.py hold the two K1 kernels against each other)."""
    _check_k1(x, w2d, halo)
    common.check_inputs("conv3x3_fwd", _inputs(x, halo, w=w2d), x.dtype)
    return _launch_simt(x, w2d, halo)


def _conv3x3_fwd_tc(x: torch.Tensor, w2d: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None,
                    halo: Optional[torch.Tensor] = None,
                    nt: Optional[int] = None) -> torch.Tensor:
    """K1's tensor-core kernel on CUDA tensors; raises outside its rule.
    ``nt`` (16, 32 or 64, dividing Cout) takes column blocks of that many
    channels instead of ``tc_nt``'s; the kernel's launcher refuses a plan
    that does not fit (the card tests and chip_smoke.py hold NT 32
    against NT 16)."""
    _, _, w, cin, cout = _check_k1(x, w2d, halo)
    out_dtype = _out_dtype(x.dtype, out_dtype)
    common.check_inputs("conv3x3_fwd", _inputs(x, halo, w=w2d), x.dtype)
    if not uses_tensor_cores(x.dtype, cin, cout, w, out_dtype):
        raise ValueError(f"conv3x3_fwd: {x.dtype} -> {out_dtype}, Cin {cin}, "
                         f"Cout {cout}, W {w} is outside the tensor-core "
                         "kernel's rule")
    return _launch_tc(x, w2d, out_dtype, halo, nt)


def _check_aligned(name: str, tensors: dict) -> None:
    """Raises on a pointer that is not 16-byte aligned (TMA's rule, and
    the halo's on every route): a view into a larger tensor, for example,
    rather than rerouting it."""
    for arg, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned "
                             f"(the kernel reads it so); pass a fresh "
                             f"tensor")


def _launch_simt(x: torch.Tensor, w2d: torch.Tensor,
                 halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    _check_aligned("conv3x3_fwd", {"halo": halo})
    b, h, w, cin = x.shape
    cout = w2d.shape[1]
    bn, rows, _ = simt_plan(b, h, w, cin, cout, _sm_count(x.device))
    if x.dtype != torch.float32 and simt_slab(cin, bn) < cin:
        # Slabs add their sums in the output: take it in fp32, round once.
        return _launch_simt(x.float(), w2d.float(),
                            None if halo is None else halo.float()
                            ).to(x.dtype)
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    common.launch("conv3x3_fwd_simt", library().odek_conv3x3_fwd,
                  x.data_ptr(), _ptr(halo), w2d.data_ptr(), out.data_ptr(),
                  b, h, w, cin, cout, bn, rows, common.DTYPE_CODES[x.dtype],
                  common.stream_handle(x))
    common.launches["conv3x3_fwd"] += 1
    _count_halo("conv3x3_fwd", x, halo)
    return out


def _launch_tc(x: torch.Tensor, w2d: torch.Tensor, out_dtype: torch.dtype,
               halo: Optional[torch.Tensor] = None,
               nt: Optional[int] = None) -> torch.Tensor:
    """``nt`` None: the kernel's own rule (tc_plan, which ``tc_nt``
    mirrors)."""
    _check_aligned("conv3x3_fwd", {"x": x, "w": w2d, "halo": halo})
    b, h, w, cin = x.shape
    cout = w2d.shape[1]
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=x.device)
    common.launch("conv3x3_fwd_tc", library().odek_conv3x3_fwd_tc,
                  x.data_ptr(), _ptr(halo), w2d.data_ptr(), out.data_ptr(),
                  b, h, w, cin, cout, _tc_tile_width(w),
                  common.DTYPE_CODES[x.dtype], common.DTYPE_CODES[out_dtype],
                  nt or 0, common.stream_handle(x))
    common.launches["conv3x3_fwd"] += 1
    nt = nt or tc_nt(cout, cin, w, out_dtype, halo is not None)
    if nt != 64:
        common.launches[f"conv3x3_fwd_nt{nt}"] += 1
    _count_halo("conv3x3_fwd", x, halo)
    return out


def conv3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor,
                        halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """patches^T . g in fp32 (fp64 for fp64 inputs, a reference); with a
    ``halo``, the patches of x's rows between the halo's, padded along W
    only, and g's own rows."""
    b, h, w, cin = x.shape
    cout = g.shape[3]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xp = (F.pad(x, (0, 0, 1, 1, 1, 1)) if halo is None
          else F.pad(_with_halo(x, halo), (0, 0, 1, 1)))
    g2 = g.reshape(b * h * w, cout).to(acc)
    cols = [xp[:, dy:dy + h, dx:dx + w, :].reshape(b * h * w, cin).to(acc)
            for dy in range(3) for dx in range(3)]
    return torch.cat([c.T @ g2 for c in cols], dim=0)


# The tensor-core K2 (csrc/conv3x3.cu::conv3x3_wgrad_tc_kernel): a block
# owns one tap row of one 64 x NT channel pair of dW and a run of tiles;
# at most this many pairs, so that every (pair, row) gets a block on any
# Hopper card (the H100 PCIe has 114 SMs).
_WGRAD_TC_MAX_PAIRS = 32


def wgrad_tc_nt(cout: int) -> int:
    """Output channels of a tensor-core K2 block: 64 where Cout % 64 == 0
    (the flagship's 64 -> 64 keeps its kernel and its bits), else 32."""
    return 64 if cout % 64 == 0 else 32


def wgrad_uses_tensor_cores(dtype: torch.dtype, cin: int, cout: int,
                            w: int) -> bool:
    """The rule that sends a K2 call on the card to the tensor-core kernel:
    bf16, Cin % 64 == 0 and Cout % 32 == 0 (a block's wgmma is 64 input by
    NT = 64 or 32 output channels, each a 128- or 64-byte swizzle row of
    its tile), and at most _WGRAD_TC_MAX_PAIRS channel pairs (Cin/64) x
    (Cout/NT) (each needs three resident blocks). Its shared memory fits
    at every width (the stages of 8 x 32 tiles at NT = 64 take the most,
    231,424 bytes), so W does not enter. Every other call takes the SIMT
    kernel; fp32 stays on SIMT, so it stays strict fp32."""
    del w  # the tile width changes the plan, not the rule
    return (dtype == torch.bfloat16 and cin % 64 == 0 and cout % 32 == 0
            and (cin // 64) * (cout // wgrad_tc_nt(cout))
            <= _WGRAD_TC_MAX_PAIRS)


@functools.lru_cache(maxsize=256)
def wgrad_tc_plan(b: int, h: int, w: int, cin: int, cout: int,
                  sms: int) -> tuple[int, int, int]:
    """(tile width, splits S, tiles per split T) of a tensor-core K2 call:
    the tiles (8 rows by TW pixels of one image, in order of image, tile
    row, tile column) go to S splits in runs of T, run s = [s*T, (s+1)*T),
    with no split empty; 3 * channel pairs * S blocks, at most ``sms``."""
    tw = _tc_tile_width(w)
    tiles = b * -(-h // _TC_TILE_ROWS) * -(-w // tw)
    pairs = (cin // 64) * (cout // wgrad_tc_nt(cout))
    cap = max(1, sms // (3 * pairs))
    per = -(-tiles // min(tiles, cap))
    return tw, -(-tiles // per), per




# The SIMT K2 (csrc/conv3x3.cu::conv3x3_wgrad_simt_kernel): a block owns
# a KT x NT tile of dW and a run of pixels in stages of 16 through a ring
# of 4. Its plan's cost model: a block's fixed share (prologue, partials,
# grid sync) in stages, and what two blocks an SM do in the time of one;
# fitted to the splits timed on an H100 80GB HBM3 (700 W) by
# ``simt_conv_times --sweep`` (PERF.md §6).
_WGRAD_SIMT_STAGE = 16
_WGRAD_SIMT_RING = 4
_WGRAD_SIMT_BLOCK_STAGES = 3
_WGRAD_SIMT_TWO_PER_SM = 1.14


def wgrad_simt_smem_bytes(kt: int, nt: int) -> int:
    """Shared memory of one SIMT K2 block: the ring of 4 stages of 16
    pixels x (KT + NT) floats, or the PG - 1 partials (PG = 256 / (KT * NT
    / 64) copies of the tile) that the first copy adds, whichever is
    larger. Mirrors csrc/conv3x3.cu::wgrad_simt_smem_bytes."""
    ring = _WGRAD_SIMT_RING * _WGRAD_SIMT_STAGE * (kt + nt)
    return 4 * max(ring, (256 * 64 // (kt * nt) - 1) * kt * nt)


def wgrad_simt_tile(b: int, h: int, w: int, cin: int,
                    cout: int) -> tuple[int, int]:
    """(KT, NT) of a SIMT K2 tile: on maps of at least 1,024 pixels, 128 x
    64 where 128 rows divide 9 * Cin (one tap at Cin 128), else 64 x 128
    where 128 columns divide Cout (no padded rows at Cin 64 -> 128); two
    copies of the tile a block, each thread 8 x 8. Else 64 x 64, four
    copies: a smaller map has too few pixels a split for the larger
    tile's fewer blocks."""
    if b * h * w >= 1024:
        if (9 * cin) % 128 == 0:
            return 128, 64
        if cout % 128 == 0:
            return 64, 128
    return 64, 64


@functools.lru_cache(maxsize=256)
def wgrad_simt_plan(b: int, h: int, w: int, cin: int, cout: int,
                    sms: int) -> tuple[int, int, int, int]:
    """(KT, NT, splits S, pixels a split P) of a SIMT K2 call; every shape
    has one. The B*H*W pixels, in stages of 16, go to S runs of P = 16 * T
    pixels, run s = [s*P, (s+1)*P), none empty. With S > 1 every block of
    the tiles x S grid must be resident at once (two an SM), since the
    splits are summed in the same launch after a grid sync. T is the one
    of least modelled time: the blocks on the busiest SM x (T + 3 stages
    of a block's fixed share), two an SM doing 1.14x the work of one in
    the same time; fewer splits on a tie. On an H100 80GB HBM3 (700 W)
    the plan was the fastest, or within 2% of it, of the tiles and splits
    ``simt_conv_times --sweep`` tries at each of its shapes (PERF.md §6).
    Mirrors the checks of csrc/conv3x3.cu::odek_conv3x3_wgrad."""
    kt, nt = wgrad_simt_tile(b, h, w, cin, cout)
    stages = -(-(b * h * w) // _WGRAD_SIMT_STAGE)
    tiles = -(-(9 * cin) // kt) * -(-cout // nt)
    best, plan = None, None
    for per in range(1, stages + 1):
        splits = -(-stages // per)
        if -(-stages // splits) != per:
            continue  # the same splits as a shorter run
        blocks = tiles * splits
        if splits > 1 and blocks > 2 * sms:
            continue
        busiest = -(-blocks // sms)
        cost = busiest * (per + _WGRAD_SIMT_BLOCK_STAGES) / (
            _WGRAD_SIMT_TWO_PER_SM if busiest > 1 else 1.0)
        if best is None or cost <= best:
            best, plan = cost, (kt, nt, splits, per * _WGRAD_SIMT_STAGE)
    return plan


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_k2(x: torch.Tensor, g: torch.Tensor,
              halo: Optional[torch.Tensor] = None) -> tuple:
    b, h, w, cin = _shape_nhwc("conv3x3_wgrad", x)
    gb, gh, gw, cout = _shape_nhwc("conv3x3_wgrad", g)
    if (gb, gh, gw) != (b, h, w):
        raise ValueError(f"conv3x3_wgrad: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} differ in (B, H, W)")
    _check_halo("conv3x3_wgrad", x, halo)
    return b, h, w, cin, cout


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor,
                  halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: input (B, H, W, Cin), cotangent (B, H, W, Cout) -> dW
    (9*Cin, Cout) in fp32. ``halo``: the input's rows above and below x
    (module docstring); g has x's rows."""
    _, _, w, cin, cout = _check_k2(x, g, halo)
    if not common.use_kernel(x):
        return conv3x3_wgrad_plain(x, g, halo)
    common.check_inputs("conv3x3_wgrad", _inputs(x, halo, g=g), x.dtype)
    if wgrad_uses_tensor_cores(x.dtype, cin, cout, w):
        return _launch_wgrad_tc(x, g, halo)
    return _launch_wgrad_simt(x, g, halo)


def _conv3x3_wgrad_simt(x: torch.Tensor, g: torch.Tensor,
                        halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2's SIMT kernel on CUDA tensors, whatever the rule says."""
    _check_k2(x, g, halo)
    common.check_inputs("conv3x3_wgrad", _inputs(x, halo, g=g), x.dtype)
    return _launch_wgrad_simt(x, g, halo)


def _conv3x3_wgrad_tc(x: torch.Tensor, g: torch.Tensor,
                      halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2's tensor-core kernel on CUDA tensors; raises outside its rule."""
    _, _, w, cin, cout = _check_k2(x, g, halo)
    common.check_inputs("conv3x3_wgrad", _inputs(x, halo, g=g), x.dtype)
    if not wgrad_uses_tensor_cores(x.dtype, cin, cout, w):
        raise ValueError(f"conv3x3_wgrad: {x.dtype}, Cin {cin}, Cout {cout}, "
                         f"W {w} is outside the tensor-core kernel's rule")
    return _launch_wgrad_tc(x, g, halo)


def _launch_wgrad_tc(x: torch.Tensor, g: torch.Tensor,
                     halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    _check_aligned("conv3x3_wgrad", {"x": x, "g": g, "halo": halo})
    b, h, w, cin = x.shape
    cout = g.shape[3]
    tw, splits, per = wgrad_tc_plan(b, h, w, cin, cout, _sm_count(x.device))
    # Each split's partials: every (pair, tap) block of 64 x NT, as many
    # floats as dW.
    scratch = torch.empty((splits, 9 * cin, cout), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((9 * cin, cout), dtype=torch.float32, device=x.device)
    # Stages 0: as many as fit, up to 4. With the splits of wgrad_tc_plan
    # that was the fastest plan at a 'model' rank's Cout 32 in ``python -m
    # ode_rl_torch.axis_conv_times`` (PERF.md §6): more stages gained
    # nothing, fewer splits lost more than their partials saved.
    common.launch("conv3x3_wgrad_tc", library().odek_conv3x3_wgrad_tc,
                  x.data_ptr(), _ptr(halo), g.data_ptr(), scratch.data_ptr(),
                  dw.data_ptr(), b, h, w, cin, cout, tw, splits, per, 0,
                  common.DTYPE_CODES[x.dtype], common.stream_handle(x))
    common.launches["conv3x3_wgrad"] += 1
    _count_halo("conv3x3_wgrad", x, halo)
    return dw


def _launch_wgrad_simt(x: torch.Tensor, g: torch.Tensor,
                       halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    _check_aligned("conv3x3_wgrad", {"halo": halo})
    b, h, w, cin = x.shape
    cout = g.shape[3]
    kt, nt, splits, per = wgrad_simt_plan(b, h, w, cin, cout,
                                          _sm_count(x.device))
    dw = torch.empty((9 * cin, cout), dtype=torch.float32, device=x.device)
    # The splits' partials, summed in the same launch after a grid sync.
    scratch = (torch.empty((splits, 9 * cin, cout), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    common.launch("conv3x3_wgrad_simt", library().odek_conv3x3_wgrad,
                  x.data_ptr(), _ptr(halo), g.data_ptr(), _ptr(scratch),
                  dw.data_ptr(), b, h, w, cin, cout, kt, nt, splits, per,
                  common.DTYPE_CODES[x.dtype], common.stream_handle(x))
    common.launches["conv3x3_wgrad"] += 1
    _count_halo("conv3x3_wgrad", x, halo)
    return dw


def flip_transpose(w2d: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """(9*Cin, Cout) -> (9*Cout, Cin): the spatially flipped,
    channel-transposed weights that turn the forward conv into dx."""
    w4d = w2d.reshape(3, 3, cin, cout)
    return torch.flip(w4d, dims=(0, 1)).permute(0, 1, 3, 2).reshape(
        9 * cout, cin).contiguous()


class Conv3x3Fn(torch.autograd.Function):
    """K1 forward; backward dx = K1 with flipped weights, dw = K2."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w2d)
        return conv3x3_fwd(x, w2d)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w2d = ctx.saved_tensors
        g = g.contiguous()
        cin, cout = x.shape[3], w2d.shape[1]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_fwd(g, flip_transpose(w2d, cin, cout)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad(x, g).to(w2d.dtype)
        return dx, dw


def conv3x3_same(x: torch.Tensor, kernel: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 stride-1 SAME conv, NHWC x HWIO -> NHWC; the bias is added in
    the input dtype, as ``nn.Conv`` does."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    out = Conv3x3Fn.apply(x, kernel.reshape(9 * cin, cout))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
