"""Builds ``ode_rl_torch/csrc`` into one shared library and loads it.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, in parallel) and links them into a library with a plain C
interface, bound with ``ctypes``. The library lands in
``build/ode_rl_torch/`` at the root of the checkout, named by a hash of
the sources and flags, so an edited source rebuilds. A failed build
raises with nvcc's messages; nothing else is built or fetched. Processes
that build at once wait on a lock in that directory, so one of them
builds.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "ode_rl_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    # x, halo, w, out, B, H, W, Cin, Cout, bn, steps_per_block, dtype,
    # stream
    "odek_conv3x3_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, halo, w, out, B, H, W, Cin, Cout, tile_w, dtype, out_dtype, nt,
    # stream
    "odek_conv3x3_fwd_tc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P],
    # x, halo, g, scratch, dw, B, H, W, Cin, Cout, kt, nt, splits,
    # px_per_split, dtype, stream
    "odek_conv3x3_wgrad": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _L, _I, _P],
    # x, halo, g, scratch, dw, B, H, W, Cin, Cout, tile_w, splits,
    # tiles_per_split, stages, dtype, stream
    "odek_conv3x3_wgrad_tc": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _P],
    # gates, h, scale, bias, z, rh, B, HW, C, G, eps, dtype, stream
    "odek_gru_gates": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # cand, z, h, scale, bias, out, B, HW, C, G, eps, dtype, stream
    "odek_gru_blend": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # gates, h, scale, bias, z, rh, B, HW, C, G, eps, threads, ranks,
    # px_per_rank, dtype, stream
    "odek_gru_gates_sample": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                              _I, _I, _I, _P],
    # cand, z, h, scale, bias, out, B, HW, C, G, eps, threads, ranks,
    # px_per_rank, dtype, stream
    "odek_gru_blend_sample": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                              _I, _I, _I, _P],
    # x, mom, B, HW, Ct, G, dtype, stream
    "odek_gru_moments": [_P, _P, _I, _I, _I, _I, _I, _P],
    # x, mom, B, HW, Ct, G, threads, ranks, px_per_rank, dtype, stream
    "odek_gru_moments_vec": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # gates, h, mom, scale, bias, z, rh, B, HW, C, G, count, eps, dtype,
    # stream
    "odek_gru_gates_mom": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                           _F, _I, _P],
    # gates, h, mom, scale, bias, z, rh, B, HW, C, G, count, eps, threads,
    # dtype, stream
    "odek_gru_gates_mom_vec": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _F, _F, _I, _I, _P],
    # cand, z, h, mom, scale, bias, out, B, HW, C, G, count, eps, dtype,
    # stream
    "odek_gru_blend_mom": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                           _F, _I, _P],
    # cand, z, h, mom, scale, bias, out, B, HW, C, G, count, eps, threads,
    # dtype, stream
    "odek_gru_blend_mom_vec": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _F, _F, _I, _I, _P],
    # f1, f2, out, B, H, W, C, max_displacement, stride, tx, ny, threads,
    # dtype, stream
    "odek_correlation_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _P],
    # f1, f2, out, B, H, W, C, max_displacement, stride, units, ck,
    # threads, dtype, stream
    "odek_correlation_fwd_pairs": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _P],
    # g, f2, gf1, B, H, W, C, max_displacement, stride, ty, tx, ncg,
    # threads, dtype, stream
    "odek_correlation_bwd_f1": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _P],
    # g, f2, gf1, B, H, W, C, max_displacement, stride, ncg, threads,
    # dtype, stream
    "odek_correlation_bwd_f1_pairs": [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                      _I, _I, _I, _P],
    # g, f1, gf2, B, H, W, C, max_displacement, stride, ty, tx, ncg,
    # threads, dtype, stream
    "odek_correlation_bwd_f2": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _P],
    # g, f1, gf2, B, H, W, C, max_displacement, stride, ncg, threads,
    # dtype, stream
    "odek_correlation_bwd_f2_pairs": [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                      _I, _I, _I, _P],
    # f1 or g, f2, out, B, H, W, C, max_displacement, stride, dtype,
    # stream
    "odek_correlation_fwd_tc": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "odek_correlation_bwd_f1_tc": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _P],
    "odek_correlation_bwd_f2_tc": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _P],
    # x, out, pixels, C, dtype, stream
    "odek_channelnorm": [_P, _P, _L, _I, _I, _P],
    # x (null for the empty kernel), out, pixels, C, stream
    "odek_channelnorm_control": [_P, _P, _L, _I, _P],
}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + NVCC_LINK_FLAGS).encode())
    for path in sources():
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libode_rl_torch_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "ode_rl_torch kernels cannot be built")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; return their stderr, or raise with the
    messages of the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [proc.communicate() for proc in procs]
    for proc, (_, err) in zip(procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code "
                               f"{proc.returncode}:\n{err}")
    return "".join(err for _, err in outs)


def build() -> str:
    """Compile the library if it is not there yet: one nvcc per source, all
    started together, then one link. Return nvcc's messages (ptxas register
    and shared-memory use), or "" if it was built. Processes that start at
    once (the ranks of a data-parallel run) build it once: each takes an
    exclusive lock on the build directory, and a process that waited for
    it finds the library there."""
    target = library_path()
    if target.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():
            return ""
        return _compile(target)


def _compile(target: pathlib.Path) -> str:
    stem = target.with_name(f"{target.stem}.{os.getpid()}")
    cus = [p for p in sources() if p.suffix == ".cu"]
    objs = [f"{stem}.{p.stem}.o" for p in cus]
    tmp = f"{stem}.tmp"
    try:
        log = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                        for src, obj in zip(cus, objs)])
        _run_all([[_nvcc(), *NVCC_LINK_FLAGS, "-o", tmp, *objs]])
        os.replace(tmp, target)
    finally:
        for path in (*objs, tmp):
            pathlib.Path(path).unlink(missing_ok=True)
    return log


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    build()
    lib = ctypes.CDLL(str(library_path()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
