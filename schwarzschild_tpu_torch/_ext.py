"""Build and load the CUDA march kernels (csrc/march.cu).

The sources compile with ``nvcc`` into a shared library with a plain C
interface, loaded with ctypes: no PyTorch headers, so the build takes
seconds.  The library is built at first use into ``_build/`` beside this
file (``compile_cache.enable_persistent_cache`` names another directory),
under a name derived from the sources and flags, so an edited source is
rebuilt and a built one is reused.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).parent / "_build"
# Where build() writes and looks up the library
# (compile_cache.enable_persistent_cache moves it).
BUILD_DIR = DEFAULT_BUILD_DIR

# The kernels' compile-time design, passed to nvcc as -D macros: csrc/
# reads them from there, the wrappers and reports from here.  The scene
# kernel's threads a block and its warp tile's rows (a warp marches
# TILE_ROWS x 32 / TILE_ROWS pixels); the adjoint's threads a block and its
# checkpoint interval (it saves a ray's core at every BWD_CKPT-th step);
# the horizon kernel's threads a block and its warp tile's rows.
DESIGN = dict(SCENE_THREADS=128, TILE_ROWS=4, BWD_THREADS=64, BWD_CKPT=8,
              BH_THREADS=256, BH_TILE_ROWS=4)

# -fmad=false: no a*b+c contraction, so the kernels round like the plain
# versions and the JAX reference (see csrc/march_common.cuh).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v") + tuple(f"-D{k}={v}" for k, v in DESIGN.items())

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Every launch function ends with (n, r_s, max_steps, max_angle, u_f, far_r2,
# stream).
_MARCH = [_I, _F, _I, _F, _F, _F, _P]
_SIGNATURES = {
    "march_bh_launch": [_P] * 3 + [_I] * 2 + [_P] * 4 + _MARCH,
    "march_bh_blocks_per_sm": [_I],
    "march_scene_launch": ([_P] * 4 + [_I] * 6 + [_F] + [_I] * 2
                           + [_P] * 9 + [_I] + _MARCH),
    "march_scene_bwd_launch": [_P] * 10 + [_I] + [_P] * 4 + _MARCH,
}


class BuildResult(NamedTuple):
    """Where the library is, what building it took (0 when it existed), and
    nvcc's output with ptxas's register and spill report."""

    path: Path
    seconds: float
    log: str
    built: bool


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildResult:
    """Compile csrc/*.cu for sm_90a unless this exact build exists."""
    out = BUILD_DIR / f"libmarch_{_digest()}.so"
    if out.exists():
        return BuildResult(out, 0.0, "", built=False)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return BuildResult(out, seconds, proc.stdout + proc.stderr, built=True)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once a process)."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t from a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address; None gives a null pointer (an output the
    kernel skips)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())
