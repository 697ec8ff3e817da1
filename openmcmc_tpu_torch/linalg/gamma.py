"""Batched Gamma(a) draws: kernel K12 and its plain version.

Port of ``openmcmc_tpu/linalg/pallas_gamma.py`` (``gamma`` :87 and its batching
rule :93, ``_pallas_gamma_flat`` :68, kernel ``_kernel`` :39). Elementwise over
``a`` of any shape, float32: a < 1 is boosted to a + 1, d = a_eff - 1/3,
c = 1 / sqrt(9 d); then N_ROUNDS = 6 fixed Marsaglia-Tsang rounds, each a
Box-Muller normal x = sqrt(-2 log u1) cos(2 pi u2) and a squeeze uniform u,
v = (1 + c x)^3, accepted when v > 0 and log u < x^2 / 2 + d - d v + d log v;
the first accepted round's d v wins, and d stands when every round misses; a
last uniform boosts a < 1 as value u^(1/a). This is not the K2 device function
``gamma_mt_elem`` (inverse-CDF normals, no boost). The JAX docstring gives the
use: large one-shot batches such as prior-predictive draws or initialisation.
No library path of the JAX package calls it, and none of the port's does.

Bits. The TPU kernel draws from the chip's generator seeded with one int32;
the port draws Philox4x32-10 with key (seed & 0x7FFFFFFF, 0) and counter
(0, 0, site, j // 4), word j % 4 for element j of the flattened ``a``. Round r
takes u1 from site 3r, u2 from 3r + 1 and u from 3r + 2; the boost uniform is
site 18. Uniforms are (i24 + 0.5) 2^-24 from the top 24 bits, as in the JAX
kernel. The stream does not depend on the launch geometry.

:func:`gamma` launches ``csrc/gamma.cu`` on CUDA tensors and runs
:func:`gamma_plain` on CPU tensors. Not ported, because it exists for the TPU
only: the padding to rows of 1024 lanes.
"""

from __future__ import annotations

import torch

from openmcmc_tpu_torch.fused import prng
from openmcmc_tpu_torch.utils import profiling

N_ROUNDS = 6
N_SITES = 3 * N_ROUNDS + 1
_TWO_PI = 6.283185307179586
_MASK31 = 0x7FFFFFFF


def _site_bits(seed: int, site: int, n: int, device) -> torch.Tensor:
    """Philox bits of one draw site for elements 0..n-1: counter (0, 0, site,
    j // 4), word j % 4 (chain 0 and sweep 0 of the fused engines' layout)."""
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    return torch.stack(prng.philox4x32(0, 0, site, groups, int(seed) & _MASK31), dim=-1).reshape(-1)[:n]


def _marsaglia_tsang(seed, a, bit_source):
    """The plain draws, float32 in a's shape, and the rounds each needs: the
    round of its first acceptance (1-based), N_ROUNDS when every round misses."""
    shape = tuple(a.shape)
    a = a.reshape(-1).to(torch.float32)
    n = a.shape[0]
    if bit_source is None:
        bit_source = lambda site, _shape: _site_bits(seed, site, n, a.device)  # noqa: E731

    def uniform(site):
        return prng.uniform((n,), lambda s: bit_source(site, s))

    needs_boost = a < 1.0
    a_eff = torch.where(needs_boost, a + 1.0, a)
    d = a_eff - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    value, accepted = d, torch.zeros_like(needs_boost)
    rounds = torch.zeros(n, dtype=torch.int32, device=a.device)
    for r in range(N_ROUNDS):
        rounds += (~accepted).to(torch.int32)
        u1, u2 = uniform(3 * r), uniform(3 * r + 1)
        x = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)
        t = 1.0 + c * x
        v = t * (t * t)
        u = uniform(3 * r + 2)
        ok = (v > 0.0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(torch.where(v > 0.0, v, 1.0)))
        value = torch.where(ok & ~accepted, d * v, value)
        accepted = accepted | ok
    u_boost = uniform(N_SITES - 1)
    value = torch.where(needs_boost, value * u_boost ** (1.0 / torch.where(needs_boost, a, 1.0)), value)
    return value.reshape(shape), rounds.reshape(shape)


@profiling.traced("kernel.gamma")
def gamma_plain(seed: int, a: torch.Tensor, bit_source=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: Gamma(a) draws, float32, a's shape.

    ``bit_source(site, shape) -> bits`` (an int64 tensor of uint32 values of
    the flattened shape) replaces the Philox bits."""
    return _marsaglia_tsang(seed, a, bit_source)[0]


def gamma_rounds(seed: int, a: torch.Tensor, bit_source=None) -> torch.Tensor:
    """The Marsaglia-Tsang rounds each draw of :func:`gamma_plain` needs, int32
    in a's shape: the round of its first acceptance, N_ROUNDS when every round
    misses. Later rounds do not change the draw; a work count (the kernel's
    bound) counts these."""
    return _marsaglia_tsang(seed, a, bit_source)[1]


@profiling.traced("kernel.gamma")
def gamma_kernel(seed: int, a: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/gamma.cu`` once over every element of a CUDA float32
    tensor ``a`` of any shape; returns the draws in a's shape. Launches on the
    current stream and does not synchronise."""
    if a.device.type != "cuda" or a.dtype != torch.float32:
        raise ValueError(f"gamma kernel: expected a CUDA float32 tensor, got {a.dtype} on {a.device}")
    if a.numel() == 0:
        raise ValueError("gamma kernel: a is empty")
    from openmcmc_tpu_torch import _build

    flat = a.reshape(-1).contiguous()
    out = torch.empty_like(flat)
    lib = _build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.gamma_launch(int(seed) & _MASK31, flat.shape[0], flat.data_ptr(), out.data_ptr(), stream)
    profiling.count("launch.gamma")
    _build.check(err, "gamma")
    return out.reshape(a.shape)


def gamma(seed: int, a: torch.Tensor, *, bit_source=None) -> torch.Tensor:
    """Gamma(a) draws elementwise, float32, for a tensor ``a`` of any shape:
    kernel K12 for a CUDA tensor, the plain version for a CPU tensor; a CUDA
    call launches the kernel or raises. ``bit_source`` (CPU only) replaces
    Philox."""
    if a.device.type == "cuda":
        if bit_source is not None:
            raise ValueError("an injected bit source replaces Philox on the CPU only")
        return gamma_kernel(seed, a)
    if a.device.type != "cpu":
        raise ValueError(f"gamma: unsupported device {a.device}")
    return gamma_plain(seed, a, bit_source=bit_source)
