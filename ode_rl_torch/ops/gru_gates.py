"""GroupNorm tails of the ConvGRU step: kernels K3 and K4.

Counterpart of ``ode_rl_tpu/ops/gru_gates.py``. The step is

    gates = GroupNorm(conv_g([x, h]));  z, r = sigmoid(split(gates))
    cand  = tanh(GroupNorm(conv_c([x, r*h])))
    h'    = (1 - z)*h + z*cand

* K3 ``fused_gru_gates`` (``csrc/gru_gates.cu``): (B,H,W,2C) raw gate conv
  output -> (z, r*h).
* K4 ``fused_gru_blend``: raw candidate conv output, z, h -> h'.

On the card each takes one of two kernels by ``sample_plan``. The
one-sample kernels (the flagship's shapes in bf16 and fp32) give a whole
sample to one block, or to a cluster of up to 8 where it does not fit one
block's shared memory: the sample comes into shared memory by bulk copies,
the moments are taken there, and each input is read from device memory
once and each output written once. Bound by those bytes (K3 6.26 µs, K4
5.01 µs at the flagship shape on an H100 at 3.35 TB/s); alone there they
take about 7.7 and 6.1 µs a call, against about 34 and 18-23 for the
two-pass kernels (H100 80GB HBM3, 700 W; PERF.md). Every other call takes
the two-pass kernels (a block per sample and group, the group read twice).
Both form r*h and the blend in fp32 and round once, where the plain
formula rounds r, z and cand to h's dtype first.

Under a ``'space'`` mesh axis (parallel/sp.py) a sample's rows lie on
several ranks, and each call takes the moments-in variants: the moments
pass ``gru_moments`` (fp32 sums of x and x^2 a (sample, group) over this
rank's rows), an all-reduce of those B*G*2 floats over ``'space'``, then
``gates_from_moments`` / ``blend_from_moments``: the epilogue on the
global moments. Each takes its vector kernel where its rule allows, else
its scalar kernel (``odek_gru_moments``, ``odek_gru_{gates,blend}_mom``):
the moments pass ``odek_gru_moments_vec`` by ``moments_plan`` (a block,
or a cluster of blocks, a sample; 16-byte vectors a thread, summed in a
fixed order), the epilogues ``odek_gru_{gates,blend}_mom_vec`` by
``mom_vec_plan`` (a block a run of one sample's pixels, each channel's
affine taken once a block, 16-byte vectors). Their plain versions
(``gru_moments_plain``, ``_gates_mom_plain``, ``_blend_mom_plain``)
compute the same from the same moments; the backward is autograd of
them with the moments' all-reduce in the graph, so it is global too.
The Functions keep the forward's mesh in ``ctx``: autograd runs a CUDA
backward on its own thread, which does not see the entered mesh.

The plain versions ``_gates_plain``/``_blend_plain`` are written out as
``_gates_xla``/``_blend_xla``. ``gates_f64``/``blend_f64`` evaluate the
Pallas kernels' formula in fp64, a reference for the bf16 kernels. The
backward of both Functions is autograd of the plain formula, recomputed
from the saved inputs, as in the JAX package.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from ode_rl_torch.ops import common
from ode_rl_torch.ops._build import library
from ode_rl_torch.parallel.mesh import SPACE_AXIS, Mesh, all_reduce_sum
from ode_rl_torch.parallel.sp import space_mesh

_EPS = 1e-5


def _groupnorm_reshape(x, scale, bias, groups, eps=_EPS,
                       acc=torch.float32):
    """(B,H,W,C) GroupNorm in ``acc`` (fp32), channels grouped contiguously
    on the last axis, one-pass moments E[x^2] - E[x]^2 clamped at 0."""
    b, h, w, c = x.shape
    xf = x.to(acc).reshape(b, h, w, groups, c // groups)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    mean2 = (xf * xf).mean(dim=(1, 2, 4), keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    norm = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return norm * scale.to(acc) + bias.to(acc)


def gru_moments_plain(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, H, W, Ct) -> (B, G, 2) fp32: the sums of x and x^2 of each
    (sample, group) over the map's pixels."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, groups, c // groups)
    return torch.stack([xf.sum(dim=(1, 3)), (xf * xf).sum(dim=(1, 3))],
                       dim=-1)


def _norm_from_moments(x, mom, scale, bias, groups, count):
    """GroupNorm of (B, H, W, C) ``x`` in fp32 with each group's moments
    from ``mom`` (B, G, 2), sums over ``count`` elements a group."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h, w, groups, c // groups)
    mean = (mom[..., 0] / count).reshape(b, 1, 1, groups, 1)
    mean2 = (mom[..., 1] / count).reshape(b, 1, 1, groups, 1)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    norm = ((xf - mean) * torch.rsqrt(var + _EPS)).reshape(b, h, w, c)
    return norm * scale.float() + bias.float()


def _gates_mom_plain(gates_raw, h, mom, scale, bias, groups, count):
    gn = _norm_from_moments(gates_raw, mom, scale, bias, groups, count)
    z, r = torch.sigmoid(gn).chunk(2, dim=-1)
    return z.to(h.dtype), r.to(h.dtype) * h


def _blend_mom_plain(cand_raw, z, h, mom, scale, bias, groups, count):
    gn = _norm_from_moments(cand_raw, mom, scale, bias, groups, count)
    cand = torch.tanh(gn).to(h.dtype)
    zc = z.to(h.dtype)
    return (1.0 - zc) * h + zc * cand


def _space_moments(x, groups, mesh: Mesh):
    """The moments of ``x``'s groups over the whole height (with their
    gradient), and their element count."""
    b, hh, w, c = x.shape
    mom = all_reduce_sum(gru_moments_plain(x, groups), mesh, SPACE_AXIS)
    return mom, float(hh * w * (c // groups) * mesh.size(SPACE_AXIS))


def _gates_plain(gates_raw, h, scale, bias, groups, mesh=None):
    if mesh is not None:
        mom, count = _space_moments(gates_raw, groups, mesh)
        return _gates_mom_plain(gates_raw, h, mom, scale, bias, groups,
                                count)
    gn = _groupnorm_reshape(gates_raw, scale, bias, groups)
    z, r = torch.sigmoid(gn).chunk(2, dim=-1)
    z = z.to(h.dtype)
    r = r.to(h.dtype)
    return z, r * h


def _blend_plain(cand_raw, z, h, scale, bias, groups, mesh=None):
    if mesh is not None:
        mom, count = _space_moments(cand_raw, groups, mesh)
        return _blend_mom_plain(cand_raw, z, h, mom, scale, bias, groups,
                                count)
    gn = _groupnorm_reshape(cand_raw, scale, bias, groups)
    cand = torch.tanh(gn).to(h.dtype)
    zc = z.to(h.dtype)
    return (1.0 - zc) * h + zc * cand


def gates_f64(gates_raw, h, scale, bias, groups):
    """The Pallas ``_gates_kernel``'s formula in fp64, unrounded: z and
    r*h with nothing rounded between the GroupNorm and the product."""
    gn = _groupnorm_reshape(gates_raw, scale, bias, groups,
                            acc=torch.float64)
    z, r = torch.sigmoid(gn).chunk(2, dim=-1)
    return z, r * h.double()


def blend_f64(cand_raw, z, h, scale, bias, groups):
    """The Pallas ``_blend_kernel``'s formula in fp64, unrounded."""
    cand = torch.tanh(_groupnorm_reshape(cand_raw, scale, bias, groups,
                                         acc=torch.float64))
    z, h = z.double(), h.double()
    return (1.0 - z) * h + z * cand


def _check_groups(name: str, channels: int, groups: int) -> None:
    if groups < 1 or channels % groups:
        raise ValueError(f"{name}: {channels} channels do not split into "
                         f"{groups} groups")


# The one-sample kernels (csrc/gru_gates.cu::gru_tail_sample): a block's
# shared memory on the H100, at most 512 threads, 8 blocks in a cluster
# (the portable limit), 4 + 1 mbarriers.
_SMEM_LIMIT = 232_448
_MAX_THREADS = 512
_MAX_RANKS = 8
_CHUNKS = 4
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


class SamplePlan(NamedTuple):
    threads: int      # a block
    ranks: int        # blocks a sample, a cluster where more than 1
    px_per_rank: int  # block r owns pixels [r * px_per_rank, ...)


@functools.lru_cache(maxsize=256)
def sample_plan(b: int, hw: int, c: int, groups: int, dtype: torch.dtype,
                align: int, blend: bool = False) -> Optional[SamplePlan]:
    """The rule that sends a K3 (or, with ``blend``, K4) call on the card
    to the one-sample kernel, and its plan; None sends it to the two-pass
    kernel. ``c`` is h's channels, ``align`` the alignment in bytes common
    to the inputs' base addresses. The kernel takes fp32 or bf16 with h's
    channels, and each group's, whole 16-byte vectors (so no vector
    straddles a group or the z/r split), bases 16-byte aligned (bulk
    copies), and a block size that is a multiple of both 32 and the vectors
    a pixel within 512 threads. A sample's pixels (3C channels each: gates
    and h, or cand, z and h) go to as few blocks as fit the shared memory,
    at most 8, in equal runs with the last one non-empty. Mirrors
    csrc/gru_gates.cu::launch_sample."""
    elem = _ELEM_BYTES.get(dtype)
    ct = c if blend else 2 * c  # channels of the normalised input
    if (elem is None or align % 16 or c * elem % 16 or groups < 1
            or ct % groups or ct // groups * elem % 16):
        return None
    step = math.lcm(ct * elem // 16, 32)
    if step > _MAX_THREADS:
        return None
    threads = _MAX_THREADS // step * step
    room = _SMEM_LIMIT - threads * 8 - groups * 16 - (_CHUNKS + 1) * 8
    most = room // (3 * c * elem)
    if most < 1:
        return None
    ranks = -(-hw // most)
    if ranks > _MAX_RANKS or b * ranks > 2**31 - 1:
        return None
    per = -(-hw // ranks)
    return SamplePlan(threads, -(-hw // per), per)


def _alignment(*ptrs: int) -> int:
    """The largest power of two dividing every address in ``ptrs``."""
    g = math.gcd(*ptrs)
    return g & -g


def _checked_affine(name: str, inputs: dict, dtype, scale, bias):
    common.check_inputs(name, inputs, dtype)
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    common.check_inputs(name, {"scale": scale, "bias": bias}, torch.float32)
    return scale, bias


def _gates_cuda(gates_raw, h, scale, bias, groups, kernel="rule"):
    """K3 on CUDA tensors: ``kernel`` "rule" takes the kernel the rule
    names, "sample" the one-sample kernel (raises outside its rule),
    "2pass" the two-pass kernel."""
    b, hh, ww, c = h.shape
    scale, bias = _checked_affine("gru_gates", {"gates_raw": gates_raw,
                                                "h": h}, h.dtype, scale, bias)
    ptrs = (gates_raw.data_ptr(), h.data_ptr())
    plan = None
    if kernel != "2pass":
        plan = sample_plan(b, hh * ww, c, groups, h.dtype,
                           _alignment(*ptrs))
        if plan is None and kernel == "sample":
            raise ValueError(f"gru_gates: {tuple(h.shape)} {h.dtype}, "
                             f"{groups} groups is outside the one-sample "
                             f"kernel's rule")
    z = torch.empty_like(h)
    rh = torch.empty_like(h)
    args = (*ptrs, scale.data_ptr(), bias.data_ptr(), z.data_ptr(),
            rh.data_ptr(), b, hh * ww, c, groups, _EPS)
    tail = (common.DTYPE_CODES[h.dtype], common.stream_handle(h))
    if plan is None:
        common.launch("gru_gates_2pass", library().odek_gru_gates, *args,
                      *tail)
    else:
        common.launch("gru_gates_sample", library().odek_gru_gates_sample,
                      *args, *plan, *tail)
    common.launches["gru_gates"] += 1
    return z, rh


def _blend_cuda(cand_raw, z, h, scale, bias, groups, kernel="rule"):
    """K4 on CUDA tensors; ``kernel`` as for ``_gates_cuda``."""
    b, hh, ww, c = h.shape
    scale, bias = _checked_affine("gru_blend", {"cand_raw": cand_raw,
                                                "z": z, "h": h}, h.dtype,
                                  scale, bias)
    ptrs = (cand_raw.data_ptr(), z.data_ptr(), h.data_ptr())
    plan = None
    if kernel != "2pass":
        plan = sample_plan(b, hh * ww, c, groups, h.dtype,
                           _alignment(*ptrs), blend=True)
        if plan is None and kernel == "sample":
            raise ValueError(f"gru_blend: {tuple(h.shape)} {h.dtype}, "
                             f"{groups} groups is outside the one-sample "
                             f"kernel's rule")
    out = torch.empty_like(h)
    args = (*ptrs, scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
            hh * ww, c, groups, _EPS)
    tail = (common.DTYPE_CODES[h.dtype], common.stream_handle(h))
    if plan is None:
        common.launch("gru_blend_2pass", library().odek_gru_blend, *args,
                      *tail)
    else:
        common.launch("gru_blend_sample", library().odek_gru_blend_sample,
                      *args, *plan, *tail)
    common.launches["gru_blend"] += 1
    return out


# The vector moments pass (csrc/gru_gates.cu::gru_moments_vec_kernel): about
# this many threads a block, each loading this many 16-byte vectors before
# its first add (kMomentsPer); a sample of more passes of a block's pixels
# than that is split over a cluster of up to 8 blocks. At the flagship's
# 'space' gates one block of 256 threads a sample read faster than 512 or
# 1024 threads, or a cluster of 2 or 4 blocks (H100; PERF.md).
_MOMENTS_THREADS = 256
_MOMENTS_PER = 8
_MOMENTS_MAX_THREADS = 1024


@functools.lru_cache(maxsize=256)
def moments_plan(b: int, hw: int, ct: int, groups: int, dtype: torch.dtype,
                 align: int) -> Optional[SamplePlan]:
    """The rule that sends a moments pass on the card to the vector kernel,
    and its plan; None sends it to the scalar kernel. ``ct`` is the
    normalised input's channels (K3's 2C, K4's C), ``align`` the
    alignment of its base address in bytes. The kernel takes fp32 or bf16
    with the channels, and each group's, whole 16-byte vectors, a 16-byte
    aligned input and a sample's HW * Ct elements within 32 bits; a block
    is a multiple of 32 and of the V vectors a pixel, about 256 threads
    and at most 1024. A sample goes to one block where its pixels take at
    most 8 passes of the block (threads / V pixels a pass), else to as few
    blocks of a cluster (at most 8) as take 8 passes each, in equal runs
    of whole passes with the last one non-empty. A function of the shape
    alone, so the summation order, and the bits, do not move between
    calls. Mirrors csrc/gru_gates.cu::odek_gru_moments_vec."""
    elem = _ELEM_BYTES.get(dtype)
    if (elem is None or align % 16 or ct * elem % 16 or groups < 1
            or ct % groups or ct // groups * elem % 16
            or hw * ct > 2**31 - 1):
        return None
    v = ct * elem // 16
    step = math.lcm(v, 32)
    if step > _MOMENTS_MAX_THREADS:
        return None
    threads = max(1, _MOMENTS_THREADS // step) * step
    passes = -(-hw // (threads // v))
    ranks = min(_MAX_RANKS, -(-passes // _MOMENTS_PER))
    per = -(-passes // ranks) * (threads // v)
    ranks = -(-hw // per)
    if b * ranks > 2**31 - 1:
        return None
    return SamplePlan(threads, ranks, per)


def _vector_route(name, kernel, plan, shape, dtype, groups):
    """The vector kernel's plan (``plan()``) for ``kernel`` "rule" or
    "vec", None for "scalar" or where the rule names the scalar kernel;
    "vec" outside the rule raises."""
    if kernel == "scalar":
        return None
    found = plan()
    if found is None and kernel == "vec":
        raise ValueError(f"{name}: {tuple(shape)} {dtype}, {groups} groups "
                         f"is outside the vector kernel's rule")
    return found


def gru_moments(x: torch.Tensor, groups: int,
                kernel: str = "rule") -> torch.Tensor:
    """The moments pass of the moments-in K3/K4: (B, H, W, Ct) -> (B, G,
    2) fp32 sums of x and x^2 a (sample, group) over this rank's rows. On
    the card ``kernel`` "rule" takes the kernel ``moments_plan`` names,
    "vec" the vector kernel (raises outside its rule), "scalar" the
    scalar kernel."""
    b, hh, ww, c = x.shape
    _check_groups("gru_moments", c, groups)
    if not common.use_kernel(x):
        return gru_moments_plain(x, groups)
    common.check_inputs("gru_moments", {"x": x}, x.dtype)
    plan = _vector_route("gru_moments", kernel, lambda: moments_plan(
        b, hh * ww, c, groups, x.dtype, _alignment(x.data_ptr())),
        x.shape, x.dtype, groups)
    mom = torch.empty((b, groups, 2), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), mom.data_ptr(), b, hh * ww, c, groups)
    tail = (common.DTYPE_CODES[x.dtype], common.stream_handle(x))
    if plan is None:
        common.launch("gru_moments_scalar", library().odek_gru_moments,
                      *args, *tail)
    else:
        common.launch("gru_moments_vec", library().odek_gru_moments_vec,
                      *args, *plan, *tail)
    common.launches["gru_moments"] += 1
    return mom


# The vector moments-in K3 and K4 (csrc/gru_gates.cu::
# gru_{gates,blend}_mom_vec_kernel): about this many threads a block, each
# with two 16-byte vectors of the normalised input; at most 1024 threads
# for K3 and 512 for K4 (whose three inputs take more registers), B in
# grid.y, at most 6144 channels of the normalised input (16 bytes a
# channel of K3's h or 8 of K4's cand for a_c and b_c, within 48 KB of
# shared memory).
_MOM_VEC_THREADS = 256
_MOM_VEC_MAX_THREADS = {False: 1024, True: 512}
_MOM_VEC_MAX_CT = 6144


@functools.lru_cache(maxsize=256)
def mom_vec_plan(b: int, hw: int, c: int, groups: int, dtype: torch.dtype,
                 align: int, blend: bool = False) -> Optional[int]:
    """The rule that sends a moments-in K3 (or, with ``blend``, K4) call on
    the card to the vector kernel, and its threads a block; None sends it
    to the scalar kernel. As ``sample_plan``: fp32 or bf16 with h's
    channels, and each group's, whole 16-byte vectors (a vector of K3's
    gates lies in z or in r), inputs 16-byte aligned (``align`` the
    alignment common to their base addresses); and B <= 65535, the
    normalised input's channels (2C for K3, C for K4) at most 6144, a
    sample's elements of it within 32 bits. The block is a multiple of the
    V vectors a pixel, about 256 threads, at most 1024 (K3) or 512 (K4).
    Mirrors csrc/gru_gates.cu::odek_gru_gates_mom_vec and
    odek_gru_blend_mom_vec."""
    elem = _ELEM_BYTES.get(dtype)
    ct = c if blend else 2 * c  # channels of the normalised input
    if (elem is None or align % 16 or c * elem % 16 or groups < 1
            or ct % groups or ct // groups * elem % 16
            or b > 65535 or ct > _MOM_VEC_MAX_CT
            or hw * ct > 2**31 - 1):
        return None
    v = ct * elem // 16
    threads = max(1, _MOM_VEC_THREADS // v) * v
    return threads if threads <= _MOM_VEC_MAX_THREADS[blend] else None


def _check_moments(name, mom, b, groups):
    if mom.shape != (b, groups, 2) or mom.dtype != torch.float32:
        raise ValueError(f"{name}: moments {tuple(mom.shape)} {mom.dtype}, "
                         f"expected ({b}, {groups}, 2) float32")


def gates_from_moments(gates_raw, h, mom, scale, bias, groups: int,
                       count: float, kernel: str = "rule"):
    """The moments-in K3: (z, r*h) with each group's statistics from
    ``mom`` (B, G, 2), sums over ``count`` elements a group. No
    autograd. On the card ``kernel`` "rule" takes the kernel
    ``mom_vec_plan`` names, "vec" the vector kernel (raises outside its
    rule), "scalar" the scalar kernel."""
    _check_gates(gates_raw, h, groups)
    _check_moments("gates_from_moments", mom, h.shape[0], groups)
    if not common.use_kernel(gates_raw):
        return _gates_mom_plain(gates_raw, h, mom, scale, bias, groups,
                                count)
    b, hh, ww, c = h.shape
    scale, bias = _checked_affine("gates_from_moments", {
        "gates_raw": gates_raw, "h": h}, h.dtype, scale, bias)
    common.check_inputs("gates_from_moments", {"mom": mom}, torch.float32)
    ptrs = (gates_raw.data_ptr(), h.data_ptr())
    threads = _vector_route(
        "gates_from_moments", kernel, lambda: mom_vec_plan(
            b, hh * ww, c, groups, h.dtype, _alignment(*ptrs)),
        h.shape, h.dtype, groups)
    z = torch.empty_like(h)
    rh = torch.empty_like(h)
    args = (*ptrs, mom.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            z.data_ptr(), rh.data_ptr(), b, hh * ww, c, groups, float(count),
            _EPS)
    tail = (common.DTYPE_CODES[h.dtype], common.stream_handle(h))
    if threads is None:
        common.launch("gru_gates_mom_scalar", library().odek_gru_gates_mom,
                      *args, *tail)
    else:
        common.launch("gru_gates_mom_vec", library().odek_gru_gates_mom_vec,
                      *args, threads, *tail)
    common.launches["gru_gates_mom"] += 1
    common.launches["gru_gates"] += 1
    return z, rh


def blend_from_moments(cand_raw, z, h, mom, scale, bias, groups: int,
                       count: float, kernel: str = "rule"):
    """The moments-in K4: the blend with the candidate's group statistics
    from ``mom`` (B, G, 2). No autograd. On the card ``kernel`` as for
    ``gates_from_moments``, by ``mom_vec_plan(..., blend=True)``."""
    _check_blend(cand_raw, z, h, groups)
    _check_moments("blend_from_moments", mom, h.shape[0], groups)
    if not common.use_kernel(cand_raw):
        return _blend_mom_plain(cand_raw, z, h, mom, scale, bias, groups,
                                count)
    b, hh, ww, c = h.shape
    scale, bias = _checked_affine("blend_from_moments", {
        "cand_raw": cand_raw, "z": z, "h": h}, h.dtype, scale, bias)
    common.check_inputs("blend_from_moments", {"mom": mom}, torch.float32)
    ptrs = (cand_raw.data_ptr(), z.data_ptr(), h.data_ptr())
    threads = _vector_route(
        "blend_from_moments", kernel, lambda: mom_vec_plan(
            b, hh * ww, c, groups, h.dtype, _alignment(*ptrs), blend=True),
        h.shape, h.dtype, groups)
    out = torch.empty_like(h)
    args = (*ptrs, mom.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, hh * ww, c, groups, float(count), _EPS)
    tail = (common.DTYPE_CODES[h.dtype], common.stream_handle(h))
    if threads is None:
        common.launch("gru_blend_mom_scalar", library().odek_gru_blend_mom,
                      *args, *tail)
    else:
        common.launch("gru_blend_mom_vec", library().odek_gru_blend_mom_vec,
                      *args, threads, *tail)
    common.launches["gru_blend_mom"] += 1
    common.launches["gru_blend"] += 1
    return out


def _moments_over_space(x, groups, mesh: Mesh):
    """The moments pass, all-reduced over ``'space'``; and the count."""
    b, hh, ww, c = x.shape
    mom = mesh.all_reduce_(gru_moments(x, groups), SPACE_AXIS)
    return mom, float(hh * ww * (c // groups) * mesh.size(SPACE_AXIS))


def _vjp_of_plain(plain, inputs, cotangents, groups):
    """Gradients of ``plain(*inputs, groups)`` for ``cotangents``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        outs = plain(*leaves, groups)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, c) for o, c in zip(outs, cotangents) if c is not None]
        return torch.autograd.grad([o for o, _ in pairs],
                                   leaves, [c for _, c in pairs],
                                   allow_unused=True)


class FusedGRUGatesFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gates_raw, h, scale, bias, groups: int, mesh=None):
        ctx.groups, ctx.mesh = groups, mesh
        ctx.save_for_backward(gates_raw, h, scale, bias)
        if common.use_kernel(gates_raw):
            if mesh is None:
                return _gates_cuda(gates_raw, h, scale, bias, groups)
            mom, count = _moments_over_space(gates_raw, groups, mesh)
            return gates_from_moments(gates_raw, h, mom, scale, bias,
                                      groups, count)
        z, rh = _gates_plain(gates_raw, h, scale, bias, groups, mesh)
        return z.contiguous(), rh

    @staticmethod
    def backward(ctx, g_z, g_rh):
        plain = functools.partial(_gates_plain, mesh=ctx.mesh)
        grads = _vjp_of_plain(plain, ctx.saved_tensors, (g_z, g_rh),
                              ctx.groups)
        return (*grads, None, None)


class FusedGRUBlendFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cand_raw, z, h, scale, bias, groups: int, mesh=None):
        ctx.groups, ctx.mesh = groups, mesh
        ctx.save_for_backward(cand_raw, z, h, scale, bias)
        if common.use_kernel(cand_raw):
            if mesh is None:
                return _blend_cuda(cand_raw, z, h, scale, bias, groups)
            mom, count = _moments_over_space(cand_raw, groups, mesh)
            return blend_from_moments(cand_raw, z, h, mom, scale, bias,
                                      groups, count)
        return _blend_plain(cand_raw, z, h, scale, bias, groups, mesh)

    @staticmethod
    def backward(ctx, g_out):
        plain = functools.partial(_blend_plain, mesh=ctx.mesh)
        grads = _vjp_of_plain(plain, ctx.saved_tensors, (g_out,),
                              ctx.groups)
        return (*grads, None, None)


def _check_gates(gates_raw, h, groups):
    if gates_raw.ndim != 4 or h.ndim != 4 or (
            gates_raw.shape[:3] != h.shape[:3]
            or gates_raw.shape[3] != 2 * h.shape[3]):
        raise ValueError(f"fused_gru_gates: gates {tuple(gates_raw.shape)} "
                         f"and h {tuple(h.shape)} do not match")
    _check_groups("fused_gru_gates", gates_raw.shape[3], groups)


def _check_blend(cand_raw, z, h, groups):
    if h.ndim != 4 or cand_raw.shape != h.shape or z.shape != h.shape:
        raise ValueError(f"fused_gru_blend: cand {tuple(cand_raw.shape)}, "
                         f"z {tuple(z.shape)} and h {tuple(h.shape)} differ")
    _check_groups("fused_gru_blend", h.shape[3], groups)


def fused_gru_gates(gates_raw: torch.Tensor, h: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor,
                    groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B,H,W,2C) raw gate conv output -> (z, r*h), each (B,H,W,C)."""
    _check_gates(gates_raw, h, groups)
    return FusedGRUGatesFn.apply(gates_raw, h, scale, bias, groups,
                                 space_mesh())


def fused_gru_blend(cand_raw: torch.Tensor, z: torch.Tensor, h: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor,
                    groups: int) -> torch.Tensor:
    """(B,H,W,C) raw candidate conv output + gate z + state h -> h_next."""
    _check_blend(cand_raw, z, h, groups)
    return FusedGRUBlendFn.apply(cand_raw, z, h, scale, bias, groups,
                                 space_mesh())


def _gru_gates_sample(gates_raw, h, scale, bias, groups):
    """K3's one-sample kernel on CUDA tensors, no autograd; raises outside
    its rule (the card tests and chip_smoke.py hold the two K3 kernels
    against each other)."""
    _check_gates(gates_raw, h, groups)
    return _gates_cuda(gates_raw, h, scale, bias, groups, "sample")


def _gru_gates_2pass(gates_raw, h, scale, bias, groups):
    """K3's two-pass kernel on CUDA tensors, whatever the rule says."""
    _check_gates(gates_raw, h, groups)
    return _gates_cuda(gates_raw, h, scale, bias, groups, "2pass")


def _gru_blend_sample(cand_raw, z, h, scale, bias, groups):
    """K4's one-sample kernel on CUDA tensors; raises outside its rule."""
    _check_blend(cand_raw, z, h, groups)
    return _blend_cuda(cand_raw, z, h, scale, bias, groups, "sample")


def _gru_blend_2pass(cand_raw, z, h, scale, bias, groups):
    """K4's two-pass kernel on CUDA tensors, whatever the rule says."""
    _check_blend(cand_raw, z, h, groups)
    return _blend_cuda(cand_raw, z, h, scale, bias, groups, "2pass")
