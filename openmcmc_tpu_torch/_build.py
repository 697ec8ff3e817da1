"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` -- one process per source, all
started together -- and linked into one shared library with a plain C interface,
loaded through ``ctypes`` on first use. The library lands in
``_build/`` beside this file (listed in ``.gitignore``) under a name that carries
a hash of the sources and flags, so an edited source rebuilds and an unchanged one
loads at once. Nothing here runs at import time: the CPU tests import every module
on a machine without ``nvcc``.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so that no multiply-add
is contracted behind the source's back -- the kernels then round exactly like the
plain PyTorch versions, which run one operation per kernel. Where a kernel wants a
fused multiply-add (the stores' products V w) it writes ``fmaf`` explicitly. No
``--use_fast_math``: approximate ``logf``/``expf``/division would move the gamma
accept/reject decisions away from the plain version's.
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

from openmcmc_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("gamma.cu", "gmrf_smoother.cu", "linreg.cu", "mixture.cu", "mmala.cu", "prng_draws.cu", "random_walk.cu",
           "rj.cu", "spectral_linreg.cu", "spectral_mmala.cu", "spectral_smoother.cu", "spectral_store.cu",
           "tridiag_canonical.cu")
HEADERS = ("layout.cuh", "philox.cuh", "prng.cuh", "spectral_store.cuh", "thomas.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p


class Build(NamedTuple):
    """What :func:`build` did: the library's path, the seconds spent compiling
    (0.0 when a library for these sources already existed), and nvcc's output."""

    path: Path
    seconds: float
    log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin on PATH")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Build:
    """Compile the kernels unless a library for these exact sources exists."""
    out = BUILD_DIR / f"libopenmcmc_kernels_{_digest()}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in SOURCES]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(CSRC / src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)
    ]
    logs = [proc.communicate()[0] for proc in procs]
    log = "".join(logs)
    failed = [src for src, proc in zip(SOURCES, procs) if proc.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    os.replace(tmp, out)
    return Build(out, seconds, log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every entry point's
    argument types declared (pointers and the stream as ``c_void_p``, so ctypes
    never truncates them to 32 bits). The first call's build and load are span
    ``build.library`` and add their time to counter ``build.library_ns``."""
    t0 = time.perf_counter_ns()
    with profiling.trace_annotated("build.library"):
        built = build()
        profiling.annotate(compiled=built.seconds > 0.0)
        lib = ctypes.CDLL(str(built.path))
    profiling.count("build.library_ns", time.perf_counter_ns() - t0)
    lib.spectral_smoother_launch.argtypes = [_P] * 12
    lib.spectral_smoother_launch.restype = ctypes.c_int
    lib.prng_draws_launch.argtypes = [_P] * 5 + [ctypes.c_int, _P]
    lib.prng_draws_launch.restype = ctypes.c_int
    lib.tridiag_canonical_launch.argtypes = [_P] * 7
    lib.tridiag_canonical_launch.restype = ctypes.c_int
    lib.gmrf_smoother_launch.argtypes = [_P] * 18
    lib.gmrf_smoother_launch.restype = ctypes.c_int
    lib.truncnorm_draws_launch.argtypes = [ctypes.c_uint32] + [_P] * 8 + [ctypes.c_int, _P]
    lib.truncnorm_draws_launch.restype = ctypes.c_int
    lib.linreg_launch.argtypes = [_P] * 13
    lib.linreg_launch.restype = ctypes.c_int
    lib.spectral_linreg_launch.argtypes = [_P] * 11
    lib.spectral_linreg_launch.restype = ctypes.c_int
    lib.random_walk_launch.argtypes = [_P] * 8
    lib.random_walk_launch.restype = ctypes.c_int
    lib.mmala_launch.argtypes = [_P] * 8
    lib.mmala_launch.restype = ctypes.c_int
    lib.spectral_mmala_launch.argtypes = [_P] * 11
    lib.spectral_mmala_launch.restype = ctypes.c_int
    lib.spectral_store_launch.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P]
    lib.spectral_store_launch.restype = ctypes.c_int
    lib.gamma_elem_draws_launch.argtypes = [ctypes.c_uint32] + [_P] * 4 + [ctypes.c_int, _P]
    lib.gamma_elem_draws_launch.restype = ctypes.c_int
    lib.mixture_launch.argtypes = [_P] * 9
    lib.mixture_launch.restype = ctypes.c_int
    lib.rj_launch.argtypes = [_P] * 6
    lib.rj_launch.restype = ctypes.c_int
    lib.gamma_launch.argtypes = [ctypes.c_uint32, ctypes.c_longlong, _P, _P, _P]
    lib.gamma_launch.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
