"""Builds ``ode_rl_torch/csrc`` into one shared library and loads it.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into a library with a
plain C interface, bound with ``ctypes``. The library lands in
``build/ode_rl_torch/`` at the root of the checkout, named by a hash of
the sources and flags, so an edited source rebuilds. A failed build
raises with nvcc's messages; nothing else is built or fetched.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "ode_rl_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    # x, w, out, B, H, W, Cin, Cout, dtype, stream
    "odek_conv3x3_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, g, scratch, dw, B, H, W, Cin, Cout, splits, rows_per_split, dtype,
    # stream
    "odek_conv3x3_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _I,
                           _P],
    # gates, h, scale, bias, z, rh, B, HW, C, G, eps, dtype, stream
    "odek_gru_gates": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # cand, z, h, scale, bias, out, B, HW, C, G, eps, dtype, stream
    "odek_gru_blend": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # f1, f2, out, B, H, W, C, max_displacement, stride, dtype, stream
    "odek_correlation_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # g, f2, gf1, B, H, W, C, max_displacement, stride, dtype, stream
    "odek_correlation_bwd_f1": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # g, f1, gf2, B, H, W, C, max_displacement, stride, dtype, stream
    "odek_correlation_bwd_f2": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, out, pixels, C, dtype, stream
    "odek_channelnorm": [_P, _P, _L, _I, _I, _P],
}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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


def build() -> str:
    """Compile the library if it is not there yet; return nvcc's messages
    (ptxas register and shared-memory use), or "" if it was built."""
    target = library_path()
    if target.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in sources() if p.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, target)
    return proc.stderr


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
