"""ctypes bridge to the native (C++/OpenMP) Moving MNIST generator.

Counterpart of ``ode_rl_tpu/data/native_gen.py``: builds
``native/mmnist_gen.cc`` (the JAX package's source, not copied) into a
shared library on first use and exposes ``generate_batch``, the writer
of the frozen corpora (``python -m ode_rl_torch.make_frozen_mmnist``).
It differs from JAX's bridge in three ways, each on purpose:

* no fallback: where the build fails, ``NativeBuildError`` carries the
  compiler's stderr (JAX falls back to a numpy generator whose stream
  differs, so a corpus would change without a word);
* the library goes to ``build/native/libmmnist_gen_<key>.so``, the key a
  hash of the source, the flags and the host (compiler version,
  ``platform.machine()``, ``platform.node()``), so a library built on
  another host and copied with the tree is rebuilt, not loaded;
* the flags hold no ``-march=native`` and set ``-ffp-contract=off``: the
  trajectory's ``y + vy * kStep * (t + 1)`` is not fused into an FMA,
  whose other rounding can move the truncated pixel by one, so the bytes
  do not depend on the host's instruction set. The generator's other
  float step is libm's ``sinf``/``cosf``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import platform
import subprocess
import time
import numpy as np

_REPO = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "mmnist_gen.cc"
BUILD_DIR = _REPO / "build" / "native"
CXX = "g++"
FLAGS = ("-O3", "-fopenmp", "-ffp-contract=off", "-shared", "-fPIC")


class NativeBuildError(RuntimeError):
    """The generator could not be compiled or loaded."""


def _compiler_version(cxx: str) -> str:
    try:
        out = subprocess.run([cxx, "--version"], check=True,
                             capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as e:
        raise NativeBuildError(f"no working C++ compiler {cxx!r}: {e}") from e
    return out.stdout.splitlines()[0] if out.stdout else ""


def host_key(source: pathlib.Path = SOURCE, cxx: str = CXX) -> str:
    """The hash that names the library: the source's bytes, the compiler
    and its flags, the compiler's version and the host."""
    h = hashlib.sha256()
    for part in (source.read_bytes(), cxx.encode(), " ".join(FLAGS).encode(),
                 _compiler_version(cxx).encode(), platform.machine().encode(),
                 platform.node().encode()):
        h.update(part)
        h.update(b"\0")
    return h.hexdigest()[:16]


class NativeGenerator:
    """The generator built from ``source`` into ``build_dir`` (once per
    host key) and loaded; ``build_seconds`` is 0.0 where the library was
    already there."""

    def __init__(self, source: os.PathLike = SOURCE,
                 build_dir: os.PathLike = BUILD_DIR, cxx: str = CXX):
        self.source = pathlib.Path(source)
        if not self.source.is_file():
            raise NativeBuildError(f"no generator source at {self.source}")
        build_dir = pathlib.Path(build_dir)
        self.path = build_dir / f"libmmnist_gen_{host_key(self.source, cxx)}.so"
        self.build_seconds = 0.0
        if not self.path.exists():
            self.build_seconds = self._build(cxx)
        try:
            lib = ctypes.CDLL(str(self.path))
        except OSError as e:
            raise NativeBuildError(f"cannot load {self.path}: {e}") from e
        lib.mmnist_generate.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.mmnist_generate.restype = None
        self.lib = lib

    def _build(self, cxx: str) -> float:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        cmd = [cxx, *FLAGS, str(self.source), "-o", str(tmp)]
        try:
            done = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
        if done.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(f"{' '.join(cmd)} exited "
                                   f"{done.returncode}:\n{done.stderr}")
        tmp.replace(self.path)   # atomic: a reader never sees half a file
        return time.perf_counter() - t0

    def generate(self, sprites: np.ndarray, seed: int, batch: int,
                 n_frames: int, num_digits: int = 2) -> np.ndarray:
        """(batch, n_frames, 64, 64) uint8 frames, deterministic in
        ``seed``; ``sprites`` (n, 28, 28) uint8."""
        sprites = np.ascontiguousarray(sprites, np.uint8)
        if sprites.ndim != 3 or sprites.shape[1:] != (28, 28):
            raise ValueError(f"sprites of shape {sprites.shape}, expected "
                             "(n, 28, 28)")
        if min(batch, n_frames, num_digits, len(sprites)) < 1:
            raise ValueError("batch, n_frames, num_digits and the sprite "
                             "count must be positive")
        out = np.zeros((batch, n_frames, 64, 64), np.uint8)
        self.lib.mmnist_generate(
            sprites.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(sprites), ctypes.c_uint64(seed), batch, n_frames, num_digits,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out


@functools.lru_cache(maxsize=None)
def native_generator() -> NativeGenerator:
    """The generator of this checkout, built on first use."""
    return NativeGenerator()


def generate_batch(sprites: np.ndarray, seed: int, batch: int,
                   n_frames: int, num_digits: int = 2) -> np.ndarray:
    """(batch, n_frames, 64, 64) uint8 frames from the native generator;
    raises ``NativeBuildError`` where it cannot be built."""
    return native_generator().generate(sprites, seed, batch, n_frames,
                                       num_digits)
