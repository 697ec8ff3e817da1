"""Canonical tridiagonal Gaussian draw: kernel K3 and its plain version.

Port of ``openmcmc_tpu/linalg/pallas_tridiag.py`` (``_pallas_batched`` :113,
kernel ``_kernel`` :43). For each of B chains, with Q tridiagonal -- diagonal
``a``, super-diagonal ``c`` (``c[:, p-1]`` unused, zero by band convention) -- it
draws x ~ N(Q^-1 b, Q^-1): the Thomas/Cholesky factor L, the forward solve
w = L^-1 b, Box-Muller noise z, and one back substitution x = L^-T (w + z).

Bits. The TPU kernel draws from the chip's generator; the port draws from
Philox4x32-10 with key (seed, 0) and counter (chain, call, site, i // 4), word
i % 4 for row i: site 0 gives u1 = (i24 + 1) 2^-24, site 1 gives u2 = i24 2^-24.
``call`` is a host integer, the draw's index within the run, so the stream does
not depend on the launch geometry.

:func:`sample_canonical_tridiag` launches ``csrc/tridiag_canonical.cu`` on CUDA
tensors and runs :func:`sample_canonical_tridiag_plain` on CPU tensors. The
kernel reads a, c and b where they lie, as (B, P) rows with contiguous columns
and a row stride each (the band rows of a batched ``Banded`` go in as views),
and writes x as a contiguous (B, P) tensor; a block of 32 chains runs their
recurrences on one consumer warp, fed by producer warps (the design is in the
kernel's source). Neither clamps a pivot (the TPU kernel does not; the JAX
package's XLA factorisation clamps at 1e-30, and for a positive-definite Q the
two agree). Not ported, because it exists for the TPU only: the BLOCK_B lane
padding and the CHUNK-row identity padding.
"""

from __future__ import annotations

import ctypes

import torch

from openmcmc_tpu_torch.fused import prng
from openmcmc_tpu_torch.utils import profiling

_TWO_PI = 6.283185307179586
_MASK32 = 0xFFFFFFFF


@profiling.traced("kernel.tridiag_canonical")
def sample_canonical_tridiag_plain(seed: int, call: int, a, c, b, bits=None):
    """Plain PyTorch version of the kernel: x (B, P) for a, c, b (B, P).

    ``bits`` = (bits1, bits2), two (B, P) int64 tensors of uint32 values (site 0
    feeds u1, site 1 u2), replaces the Philox bits (the CPU tests' injected source)."""
    n_chains, p = a.shape
    if bits is None:  # sites 0 and 1 of "sweep" call: the kernel's counter layout
        bits = prng.sweep_bits(seed, n_chains, call, (p, p), a.device)
    i1, i2 = ((t.to(torch.int64) & _MASK32) >> 8 for t in bits)
    u1 = (i1.to(a.dtype) + 1.0) * (1.0 / 16777216.0)
    u2 = i2.to(a.dtype) * (1.0 / 16777216.0)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)
    ld_prev = torch.ones((n_chains,), dtype=a.dtype, device=a.device)
    w_prev = torch.zeros_like(ld_prev)
    c_prev = torch.zeros_like(ld_prev)
    ld_rows, u_rows = [], []
    for i in range(p):
        l_prev = c_prev / ld_prev
        ld = torch.sqrt(a[:, i] - l_prev * l_prev)
        w = (b[:, i] - l_prev * w_prev) / ld
        ld_rows.append(ld)
        u_rows.append(w + z[:, i])
        ld_prev, w_prev, c_prev = ld, w, c[:, i]
    x_next = torch.zeros_like(ld_prev)
    x_rows = [None] * p
    for i in reversed(range(p)):
        ld = ld_rows[i]
        x_next = (u_rows[i] - (c[:, i] / ld) * x_next) / ld
        x_rows[i] = x_next
    return torch.stack(x_rows, dim=1)


class TridiagParams(ctypes.Structure):
    """Mirror of ``struct TridiagParams`` in ``csrc/tridiag_canonical.cu``."""

    _fields_ = [
        ("seed", ctypes.c_uint32),
        ("call", ctypes.c_uint32),
        ("n_chains", ctypes.c_int32),
        ("p", ctypes.c_int32),
        ("sa", ctypes.c_int64),
        ("sc", ctypes.c_int64),
        ("sb", ctypes.c_int64),
        ("slot_rows", ctypes.c_int32),
        ("n_slots", ctypes.c_int32),
    ]


TILE = 128  # rows per tile of the kernel's ring (kTile)
_CHAINS = 32  # chains per block (kChains)


def _check(a, c, b):
    if a.dim() != 2 or a.shape[0] < 1 or a.shape[1] < 1:
        raise ValueError(f"tridiagonal draw: a must be a non-empty (B, P) tensor, got {tuple(a.shape)}")
    for name, t in (("c", c), ("b", b)):
        if tuple(t.shape) != tuple(a.shape) or t.device != a.device or t.dtype != a.dtype:
            raise ValueError(f"tridiagonal draw: {name} must match a's shape {tuple(a.shape)}, device and dtype")


def _rows(t):
    """t as (B, P) rows with contiguous columns and a non-negative row stride: a
    view when it is one already (the band rows of a batched Banded), else a copy."""
    return t if t.stride(1) == 1 and t.stride(0) >= 0 else t.contiguous()


def launch_args(seed: int, call: int, a, c, b):
    """The kernel's arguments for CUDA float32 (B, P) a, c, b: its parameters,
    the rows as it reads them, a new contiguous x and the global scratch (the
    tiles that leave the ring before the back pass: ld, u, c / ld and ~1 / ld
    per row and chain; None at p <= 256, where no tile leaves it)."""
    n_chains, p = a.shape
    a, c, b = (_rows(t) for t in (a, c, b))
    x = torch.empty((n_chains, p), dtype=a.dtype, device=a.device)
    n_tiles = -(-p // TILE)
    n_spill = -(-n_chains // _CHAINS) * max(n_tiles - 2, 0) * 4 * TILE * _CHAINS
    scratch = torch.empty((n_spill,), dtype=a.dtype, device=a.device) if n_spill else None
    prm = TridiagParams(seed=int(seed) & _MASK32, call=int(call), n_chains=n_chains, p=p, sa=a.stride(0),
                        sc=c.stride(0), sb=b.stride(0), slot_rows=min(p, TILE), n_slots=1 if n_tiles == 1 else 2)
    return prm, a, c, b, x, scratch


def launch(prm, a, c, b, x, scratch):
    """One launch on :func:`launch_args`' arguments, on the current stream; raises
    if the launch is refused. Counts nothing."""
    from openmcmc_tpu_torch import _build

    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _build.library().tridiag_canonical_launch(
            ctypes.byref(prm), a.data_ptr(), c.data_ptr(), b.data_ptr(), x.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream,
        )
    _build.check(err, "tridiag_canonical")


@profiling.traced("kernel.tridiag_canonical")
def sample_canonical_tridiag_kernel(seed: int, call: int, a, c, b):
    """Launch ``csrc/tridiag_canonical.cu`` on CUDA float32 tensors (arguments
    as :func:`sample_canonical_tridiag_plain`). a, c and b are read in place as
    (B, P) rows with their own row strides; x is a new contiguous (B, P)
    tensor. Launches on the current stream and does not synchronise."""
    _check(a, c, b)
    if a.device.type != "cuda" or a.dtype != torch.float32:
        raise ValueError(f"tridiagonal kernel: expected CUDA float32 tensors, got {a.dtype} on {a.device}")
    if not 0 <= int(call) <= _MASK32:
        raise ValueError(f"tridiagonal kernel: call counter {call} does not fit 32 bits")
    args = launch_args(seed, call, a, c, b)
    profiling.count("launch.tridiag_canonical")
    launch(*args)
    return args[4]


def sample_canonical_tridiag(seed: int, call: int, a, c, b, bits=None):
    """x ~ N(Q^-1 b, Q^-1) per row for tridiagonal Q = (a, c); a, c, b are
    (B, P). The kernel for CUDA tensors, the plain version for CPU tensors; a
    CUDA call launches the kernel or raises. ``bits`` (CPU only) replaces Philox."""
    if a.device.type == "cuda":
        if bits is not None:
            raise ValueError("injected bits replace Philox on the CPU only")
        return sample_canonical_tridiag_kernel(seed, call, a, c, b)
    if a.device.type != "cpu":
        raise ValueError(f"tridiagonal draw: unsupported device {a.device}")
    _check(a, c, b)
    return sample_canonical_tridiag_plain(seed, call, a, c, b, bits=bits)
