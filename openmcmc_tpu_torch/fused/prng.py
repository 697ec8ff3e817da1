"""Random-number layer of the fused engines: Philox bits and the sampling transforms.

Port of ``openmcmc_tpu/fused/prng.py``. On the card these functions run inside
the kernels (``csrc/philox.cuh``, ``csrc/prng.cuh``); here are their plain
PyTorch versions, which the CPU path and the CPU tests run, and the wrappers of
the ``prng_draws``, ``truncnorm_draws`` and ``gamma_elem_draws`` kernels, which
expose the device functions over a tensor of counters so that they can be
checked on their own. ``truncnorm_logpdf`` runs inlined in the random-walk
kernel (K7), ``gamma_mt_elem`` in the mixture kernel (K10).

Bits. The TPU kernels draw from the chip's hardware generator, reseeded per grid
program. The port draws from Philox4x32-10 with a counter layout that does not
depend on the launch geometry:

    key = (seed, 0),   counter = (chain, sweep, site, j // 4),   word j % 4 -> element j

where a *site* is the draw's position within the sweep, in the JAX kernel's
order. :func:`philox4x32` reproduces the kernel's bits with int64 tensor ops
(16-bit limbs for the 32 x 32 -> 64 multiply, which overflows a signed int64).

Bit sources. Every sampling function takes ``bit_source``, a callable
``shape -> bits``: an int64 tensor of uint32 values, one per element. This is the
JAX package's ``bit_source=`` hook, and how the CPU tests feed the JAX kernel's
exact bits into the port. There is no process-wide installed source.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

LOG_2PI = 1.8378770664093453
GAMMA_ROUNDS = 6
_SQRT2 = 1.4142135623730951
_INV_SQRT2 = 0.7071067811865476
_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85

# Giles (2012) single-precision inverse-erf coefficients: (central, tail)
_ERFINV_COEFFS = (
    (2.81022636e-08, -2.00214257e-04),
    (3.43273939e-07, 1.00950558e-04),
    (-3.5233877e-06, 1.34934322e-03),
    (-4.39150654e-06, -3.67342844e-03),
    (2.1858087e-04, 5.73950773e-03),
    (-1.25372503e-03, -7.62246130e-03),
    (-4.17768164e-03, 9.43887047e-03),
    (2.46640727e-01, 1.00167406e00),
    (1.50140941e00, 2.83297682e00),
)


# ---------------------------------------------------------------------------
# Philox4x32-10
# ---------------------------------------------------------------------------


def _mulhilo(a: int, b: torch.Tensor):
    """(lo, hi) 32-bit halves of the constant ``a`` times ``b`` (uint32 values in int64)."""
    p_lo = a * (b & 0xFFFF)  # < 2^48
    p_hi = a * (b >> 16)  # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return t & _MASK32, (p_hi >> 16) + (t >> 32)


def philox4x32(c0, c1, c2, c3, key0: int, key1: int = 0):
    """Philox4x32-10 on broadcastable int64 counter words; returns four int64
    tensors of uint32 values (Random123's ``philox4x32_R(10, ...)``)."""
    dev = next((c.device for c in (c0, c1, c2, c3) if torch.is_tensor(c)), None)
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64, device=dev) for c in (c0, c1, c2, c3))
    )
    k0, k1 = int(key0) & _MASK32, int(key1) & _MASK32
    for _ in range(10):
        lo0, hi0 = _mulhilo(_M0, c0)
        lo1, hi1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def sweep_bits(seed: int, n_chains: int, sweep: int, widths, device):
    """Philox bits of every draw site of one sweep, in one batched evaluation.

    ``widths[k]`` is the element count of site k. Returns a list of
    (n_chains, widths[k]) int64 tensors."""
    groups = [(w + 3) // 4 for w in widths]
    site = torch.cat([torch.full((g,), k, dtype=torch.int64) for k, g in enumerate(groups)])
    grp = torch.cat([torch.arange(g, dtype=torch.int64) for g in groups])
    chain = torch.arange(n_chains, dtype=torch.int64, device=device)[:, None]
    words = philox4x32(chain, sweep, site.to(device)[None, :], grp.to(device)[None, :], seed)
    flat = torch.stack(words, dim=-1).reshape(n_chains, -1)  # (chains, 4 * sum(groups))
    out, start = [], 0
    for w, g in zip(widths, groups):
        out.append(flat[:, start : start + w])
        start += 4 * g
    return out


class SiteStream:
    """A bit source that hands out one sweep's sites in order: the k-th call gets
    ``sites[k]`` (its shape must match the request)."""

    def __init__(self, sites):
        self._sites = list(sites)
        self._next = 0

    def __call__(self, shape):
        bits = self._sites[self._next]
        self._next += 1
        if tuple(bits.shape) != tuple(shape):
            raise ValueError(f"draw site {self._next - 1}: bits of shape {tuple(bits.shape)}, asked {tuple(shape)}")
        return bits


# ---------------------------------------------------------------------------
# sampling transforms (JAX operation order, float32)
# ---------------------------------------------------------------------------


def _mt_rounds(a_star: float) -> int:
    """Squeeze rounds for a static Marsaglia-Tsang shape (same tiers as the JAX
    package: miss probability under ~5e-9 per draw)."""
    if a_star < 4.0:
        return GAMMA_ROUNDS
    if a_star < 16.0:
        return 4
    return 3


def uniform(shape, bit_source):
    """U(0, 1) from the top 24 bits: (i + 0.5) / 2^24."""
    i24 = (bit_source(shape).to(torch.int64) & _MASK32) >> 8
    return (i24.to(torch.float32) + 0.5) * (1.0 / 16777216.0)


def erfinv_poly(t: torch.Tensor) -> torch.Tensor:
    """Giles (2012) single-precision inverse erf polynomial."""
    w = -torch.log((1.0 - t) * (1.0 + t))
    small = w < 5.0
    arg = torch.where(small, w - 2.5, torch.sqrt(torch.clamp(w, min=1e-30)) - 3.0)
    coef = torch.tensor(_ERFINV_COEFFS, dtype=torch.float32, device=t.device)
    p = torch.where(small, coef[0, 0], coef[0, 1])
    for i in range(1, len(_ERFINV_COEFFS)):
        p = p * arg + torch.where(small, coef[i, 0], coef[i, 1])
    return p * t


def normal_icdf(shape, bit_source):
    """N(0, 1) via the inverse CDF: sqrt(2) erfinv(2u - 1), with 2u - 1 clamped to
    +-(1 - 1.2e-7) so that |z| stays finite."""
    u = uniform(shape, bit_source)
    t = torch.clamp(2.0 * u - 1.0, -1.0 + 1.2e-7, 1.0 - 1.2e-7)
    return _SQRT2 * erfinv_poly(t)


def erf_poly(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 erf polynomial (max abs error 1.5e-7): the
    kernels' erf, exp and one division only. Saturates to +-1 for huge |x|."""
    sgn = torch.where(x < 0.0, -1.0, 1.0)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return sgn * (1.0 - poly * torch.exp(-ax * ax))


def truncnorm_draw(mu, scale, lo, hi, shape, bit_source):
    """Inverse-CDF truncated-normal draw on [lo, hi] with the polynomial erf pair:
    the standardized bounds' erf values, one uniform, the Giles inverse erf with
    its argument clamped to +-(1 - 1e-7), then the draw clipped into the bounds
    in both coordinates. An open side is +-1e30, whose erf saturates to +-1."""
    a = (lo - mu) / scale
    b = (hi - mu) / scale
    ea = erf_poly(a * _INV_SQRT2)
    eb = erf_poly(b * _INV_SQRT2)
    u = uniform(shape, bit_source)
    t = ea + u * (eb - ea)
    z = _SQRT2 * erfinv_poly(torch.clamp(t, -1.0 + 1e-7, 1.0 - 1e-7))
    z = torch.minimum(torch.maximum(z, a), b)
    return torch.minimum(torch.maximum(mu + scale * z, lo), hi)


def truncnorm_logpdf(x, mu, scale, lo, hi):
    """Truncated-normal log-density on [lo, hi] with the polynomial erf: the box
    mass 0.5 (erf(b / sqrt 2) - erf(a / sqrt 2)) clamped at 1e-30, and -inf
    outside [lo, hi] (a reverse proposal density at a point outside the box
    must force a rejection)."""
    a = (lo - mu) / scale
    b = (hi - mu) / scale
    z = (x - mu) / scale
    mass = 0.5 * (erf_poly(b * _INV_SQRT2) - erf_poly(a * _INV_SQRT2))
    dens = -0.5 * (z * z + LOG_2PI) - torch.log(scale) - torch.log(torch.clamp(mass, min=1e-30))
    return torch.where((x >= lo) & (x <= hi), dens, -torch.inf)


def _mt_squeeze(d, c, value, rate, rounds, bit_source):
    shape = tuple(rate.shape)
    accepted = torch.zeros(shape, dtype=torch.bool, device=rate.device)
    for _ in range(rounds):
        x = normal_icdf(shape, bit_source)
        t = 1.0 + c * x
        v = t * (t * t)
        u = uniform(shape, bit_source)
        ok = (v > 0.0) & (
            torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(torch.where(v > 0.0, v, 1.0))
        )
        value = torch.where(ok & ~accepted, d * v, value)
        accepted = accepted | ok
    return value


def gamma_mt(a_star: float, rate: torch.Tensor, bit_source):
    """Marsaglia-Tsang Gamma(a_star) / rate elementwise; shapes below 1 use the
    boost G(a) = G(a + 1) U^(1/a)."""
    if a_star < 1.0:
        g1 = gamma_mt(a_star + 1.0, torch.ones_like(rate), bit_source)
        u = uniform(tuple(rate.shape), bit_source)
        return g1 * torch.exp(torch.log(u) / a_star) / rate
    d = a_star - 1.0 / 3.0
    c = 1.0 / float(np.sqrt(9.0 * d))
    value = _mt_squeeze(d, c, torch.full_like(rate, d), rate, _mt_rounds(a_star), bit_source)
    return value / rate


def gamma_mt_elem(a_star: torch.Tensor, rate: torch.Tensor, bit_source):
    """Marsaglia-Tsang Gamma(a_star) / rate with an elementwise shape tensor
    a_star >= 1: GAMMA_ROUNDS fixed rounds, no shape < 1 boost, and the value d
    when no round accepts. Each round draws the normals, then the uniforms, at
    the shape of ``rate``. Callers guarantee a_star >= 1 (the mixture matcher
    through a0 >= 1)."""
    d = a_star - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    return _mt_squeeze(d, c, d, rate, GAMMA_ROUNDS, bit_source) / rate


def gamma_mt2(a1: float, a2: float, rate1: torch.Tensor, rate2: torch.Tensor, bit_source):
    """Two independent Gamma draws sharing each round's draw sites.

    ``rate1``/``rate2`` are (chains, 1) columns; each round draws (chains, 2)
    normals and uniforms, element 0 for the first shape and 1 for the second.
    Shapes below 1 fall back to two sequential :func:`gamma_mt` calls."""
    if a1 < 1.0 or a2 < 1.0:
        return gamma_mt(a1, rate1, bit_source), gamma_mt(a2, rate2, bit_source)
    rate = torch.cat([rate1, rate2], dim=1)
    d = torch.cat([torch.full_like(rate1, a1 - 1.0 / 3.0), torch.full_like(rate2, a2 - 1.0 / 3.0)], dim=1)
    c = 1.0 / torch.sqrt(9.0 * d)
    value = _mt_squeeze(d, c, d, rate, max(_mt_rounds(a1), _mt_rounds(a2)), bit_source)
    out = value / rate
    return out[:, 0:1], out[:, 1:2]


# ---------------------------------------------------------------------------
# Gamma specs shared by the kernels: the constants gamma_mt2/gamma_mt compute
# ---------------------------------------------------------------------------


class GammaSpec(ctypes.Structure):
    """Mirror of ``struct GammaSpec`` in ``csrc/prng.cuh``."""

    _fields_ = [
        ("d", ctypes.c_float),
        ("c", ctypes.c_float),
        ("a", ctypes.c_float),
        ("rounds", ctypes.c_int32),
        ("boost", ctypes.c_int32),
        ("site0", ctypes.c_int32),
        ("elem", ctypes.c_int32),
    ]


def _single_spec(a: float, site0: int) -> GammaSpec:
    """Spec of one :func:`gamma_mt` draw starting at ``site0`` (element 0)."""
    boost = a < 1.0
    a_mt = a + 1.0 if boost else a
    d = a_mt - 1.0 / 3.0
    return GammaSpec(
        d=d, c=float(np.float32(1.0 / float(np.sqrt(9.0 * d)))), a=a,
        rounds=_mt_rounds(a_mt), boost=int(boost), site0=site0, elem=0,
    )


def gamma_pair_specs(a1: float, a2: float, site0: int = 1):
    """The two specs of a :func:`gamma_mt2` draw whose sites start at ``site0``,
    and the element count of each site it consumes, in order."""
    if a1 < 1.0 or a2 < 1.0:
        s1 = _single_spec(a1, site0)
        n1 = 2 * s1.rounds + s1.boost
        s2 = _single_spec(a2, site0 + n1)
        return s1, s2, [1] * (n1 + 2 * s2.rounds + s2.boost)
    rounds = max(_mt_rounds(a1), _mt_rounds(a2))
    specs = []
    for elem, a in enumerate((a1, a2)):
        d = np.float32(a - 1.0 / 3.0)
        c = np.float32(1.0) / np.sqrt(np.float32(9.0) * d)
        specs.append(GammaSpec(d=float(d), c=float(c), a=a, rounds=rounds, boost=0, site0=site0, elem=elem))
    return specs[0], specs[1], [2] * (2 * rounds)


# ---------------------------------------------------------------------------
# prng_draws: the device functions over a tensor of counters
# ---------------------------------------------------------------------------


class DrawsParams(ctypes.Structure):
    """Mirror of ``struct DrawsParams`` in ``csrc/prng_draws.cu``."""

    _fields_ = [
        ("seed", ctypes.c_uint32),
        ("rate1", ctypes.c_float),
        ("rate2", ctypes.c_float),
        ("g1", GammaSpec),
        ("g2", GammaSpec),
    ]


def draws_plain(seed: int, ctr: torch.Tensor, a1: float, a2: float, rate1: float = 1.0, rate2: float = 1.0):
    """Plain version of :func:`draws`: per counter row, the 4 uniforms and 4
    normals of its Philox block, and a :func:`gamma_mt2` pair drawn as the
    smoother draws it for chain = ctr[:, 0], sweep = ctr[:, 1]."""
    c = ctr.to(torch.int64) & _MASK32
    words = torch.stack(philox4x32(c[:, 0], c[:, 1], c[:, 2], c[:, 3], seed), dim=1)
    uni = uniform(tuple(words.shape), lambda shape: words)
    nrm = normal_icdf(tuple(words.shape), lambda shape: words)
    _, _, widths = gamma_pair_specs(a1, a2)
    sites = []
    for k, w in enumerate(widths):
        blk = philox4x32(c[:, 0], c[:, 1], k + 1, 0, seed)
        sites.append(torch.stack(blk, dim=1)[:, :w])
    n = ctr.shape[0]
    r1 = torch.full((n, 1), rate1, dtype=torch.float32, device=ctr.device)
    r2 = torch.full((n, 1), rate2, dtype=torch.float32, device=ctr.device)
    g1, g2 = gamma_mt2(a1, a2, r1, r2, SiteStream(sites))
    return uni, nrm, torch.cat([g1, g2], dim=1)


def draws(seed: int, ctr: torch.Tensor, a1: float, a2: float, rate1: float = 1.0, rate2: float = 1.0):
    """Uniforms (n, 4), normals (n, 4) and Gamma pairs (n, 2) for a (n, 4) int32
    tensor of Philox counters (uint32 bit patterns).

    A CUDA tensor launches the ``prng_draws`` kernel; a CPU tensor takes
    :func:`draws_plain`."""
    if ctr.device.type == "cpu":
        return draws_plain(seed, ctr, a1, a2, rate1, rate2)
    if ctr.device.type != "cuda":
        raise ValueError(f"prng draws: unsupported device {ctr.device}")
    if ctr.dtype != torch.int32 or ctr.dim() != 2 or ctr.shape[1] != 4 or not ctr.is_contiguous():
        raise ValueError("prng draws: counters must be a contiguous (n, 4) int32 tensor")
    from openmcmc_tpu_torch import _build

    n = ctr.shape[0]
    uni = torch.empty((n, 4), dtype=torch.float32, device=ctr.device)
    nrm = torch.empty((n, 4), dtype=torch.float32, device=ctr.device)
    gam = torch.empty((n, 2), dtype=torch.float32, device=ctr.device)
    s1, s2, _ = gamma_pair_specs(a1, a2)
    prm = DrawsParams(seed=int(seed) & _MASK32, rate1=rate1, rate2=rate2, g1=s1, g2=s2)
    lib = _build.library()
    with torch.cuda.device(ctr.device):
        stream = torch.cuda.current_stream(ctr.device).cuda_stream
        err = lib.prng_draws_launch(
            ctypes.byref(prm), ctr.data_ptr(), uni.data_ptr(), nrm.data_ptr(), gam.data_ptr(), n, stream
        )
    draws.launches += 1
    _build.check(err, "prng_draws")
    return uni, nrm, gam


draws.launches = 0


def truncnorm_draws_plain(seed: int, ctr: torch.Tensor, x, mu, scale, lo, hi):
    """Plain version of :func:`truncnorm_draws`: per counter row, ``erf_poly(x)``
    and a :func:`truncnorm_draw` on each of the 4 words of its Philox block."""
    c = ctr.to(torch.int64) & _MASK32
    words = torch.stack(philox4x32(c[:, 0], c[:, 1], c[:, 2], c[:, 3], seed), dim=1)
    return erf_poly(x), truncnorm_draw(mu, scale, lo, hi, tuple(words.shape), lambda shape: words)


def truncnorm_draws(seed: int, ctr: torch.Tensor, x, mu, scale, lo, hi):
    """``erf_poly(x)`` and truncated-normal draws on [lo, hi] (all (n, 4) float32)
    for a (n, 4) int32 tensor of Philox counters: the device functions the Thomas
    kernel inlines, launched alone. A CUDA tensor launches ``truncnorm_draws``
    (``csrc/prng_draws.cu``); a CPU tensor takes :func:`truncnorm_draws_plain`."""
    if ctr.device.type == "cpu":
        return truncnorm_draws_plain(seed, ctr, x, mu, scale, lo, hi)
    if ctr.device.type != "cuda":
        raise ValueError(f"truncnorm draws: unsupported device {ctr.device}")
    if ctr.dtype != torch.int32 or ctr.dim() != 2 or ctr.shape[1] != 4 or not ctr.is_contiguous():
        raise ValueError("truncnorm draws: counters must be a contiguous (n, 4) int32 tensor")
    for t in (x, mu, scale, lo, hi):
        if t.shape != ctr.shape or t.dtype != torch.float32 or t.device != ctr.device or not t.is_contiguous():
            raise ValueError("truncnorm draws: x, mu, scale, lo, hi must be contiguous (n, 4) float32 on ctr's device")
    from openmcmc_tpu_torch import _build

    n = ctr.shape[0]
    erf = torch.empty_like(x)
    out = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(ctr.device):
        stream = torch.cuda.current_stream(ctr.device).cuda_stream
        err = lib.truncnorm_draws_launch(
            int(seed) & _MASK32, ctr.data_ptr(), x.data_ptr(), mu.data_ptr(), scale.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), erf.data_ptr(), out.data_ptr(), n, stream,
        )
    truncnorm_draws.launches += 1
    _build.check(err, "truncnorm_draws")
    return erf, out


truncnorm_draws.launches = 0


def gamma_elem_sites(seed: int, ctr: torch.Tensor):
    """The 2 GAMMA_ROUNDS draw sites a :func:`gamma_elem_draws` row reads: round r
    takes its normals from site ctr[:, 2] + 2r and its uniforms from the next
    site, each the Philox block (chain, sweep, site, ctr[:, 3]), as (n, 4) words."""
    c = ctr.to(torch.int64) & _MASK32
    return [torch.stack(philox4x32(c[:, 0], c[:, 1], c[:, 2] + k, c[:, 3], seed), dim=1)
            for k in range(2 * GAMMA_ROUNDS)]


def gamma_elem_draws_plain(seed: int, ctr: torch.Tensor, a_star: torch.Tensor, rate: torch.Tensor):
    """Plain version of :func:`gamma_elem_draws`: :func:`gamma_mt_elem` on the 4
    elements of each counter row, on the row's sites."""
    return gamma_mt_elem(a_star, rate, SiteStream(gamma_elem_sites(seed, ctr)))


def gamma_elem_draws(seed: int, ctr: torch.Tensor, a_star: torch.Tensor, rate: torch.Tensor):
    """Gamma(a_star) / rate draws (n, 4) for a (n, 4) int32 tensor of counter rows
    (chain, sweep, site0, group): element j of a row is the ``gamma_mt_elem``
    device function the mixture kernel inlines, at element 4 group + j of its
    sites. A CUDA tensor launches ``gamma_elem_draws`` (``csrc/prng_draws.cu``);
    a CPU tensor takes :func:`gamma_elem_draws_plain`."""
    if ctr.device.type == "cpu":
        return gamma_elem_draws_plain(seed, ctr, a_star, rate)
    if ctr.device.type != "cuda":
        raise ValueError(f"gamma elem draws: unsupported device {ctr.device}")
    if ctr.dtype != torch.int32 or ctr.dim() != 2 or ctr.shape[1] != 4 or not ctr.is_contiguous():
        raise ValueError("gamma elem draws: counters must be a contiguous (n, 4) int32 tensor")
    for t in (a_star, rate):
        if t.shape != ctr.shape or t.dtype != torch.float32 or t.device != ctr.device or not t.is_contiguous():
            raise ValueError("gamma elem draws: a_star and rate must be contiguous (n, 4) float32 on ctr's device")
    from openmcmc_tpu_torch import _build

    out = torch.empty_like(rate)
    lib = _build.library()
    with torch.cuda.device(ctr.device):
        stream = torch.cuda.current_stream(ctr.device).cuda_stream
        err = lib.gamma_elem_draws_launch(int(seed) & _MASK32, ctr.data_ptr(), a_star.data_ptr(), rate.data_ptr(),
                                          out.data_ptr(), ctr.shape[0], stream)
    gamma_elem_draws.launches += 1
    _build.check(err, "gamma_elem_draws")
    return out


gamma_elem_draws.launches = 0
