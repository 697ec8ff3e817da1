"""Special functions for the samplers (port of ``openmcmc_tpu/linalg/random.py``).

:func:`fast_erfinv`, which the generic driver's truncated-normal draws use. It
is not ``fused.prng.erfinv_poly``: the two clamp differently (1e-37 on 1 - x^2
here, 1e-30 on w there) and branch differently, as in the JAX package, so each
keeps its own copy.

:func:`fast_gamma`: Marsaglia-Tsang (2000) squeeze-rejection Gamma sampling with
a FIXED number of vectorised candidate rounds (N_ROUNDS = 8) instead of a
data-dependent loop, shapes below 1 boosted as G(a) = G(a + 1) U^(1/a). It is the
plain sampler the JAX package runs on the un-batched path of
``pallas_gamma.gamma``; its normals and uniforms come from an explicit
``torch.Generator``. No library path calls it (the batched draw is
:mod:`openmcmc_tpu_torch.linalg.gamma`, kernel K12).
"""

from __future__ import annotations

import torch

N_ROUNDS = 8
_CENTRAL = (3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
            -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_TAIL = (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
         -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def fast_erfinv(x: torch.Tensor) -> torch.Tensor:
    """Single-precision inverse erf (Giles 2012): both polynomial branches in
    w = -log(1 - x^2), evaluated everywhere and selected at w < 5."""
    w = -torch.log(torch.clamp((1.0 - x) * (1.0 + x), min=1e-37))
    wc = w - 2.5
    p1 = torch.full_like(x, 2.81022636e-08)
    for coef in _CENTRAL:
        p1 = coef + p1 * wc
    wt = torch.sqrt(torch.clamp(w, min=5.0)) - 3.0
    p2 = torch.full_like(x, -0.000200214257)
    for coef in _TAIL:
        p2 = coef + p2 * wt
    return torch.where(w < 5.0, p1, p2) * x


def fast_gamma(a, generator: torch.Generator, rate=None) -> torch.Tensor:
    """Draw Gamma(a) (divided by ``rate`` when given) elementwise; ``a`` any
    shape, a > 0, on ``generator``'s device. Each round draws the normals, then
    the uniforms (minval 1e-37, as in the JAX package); the boost uniform comes
    last. A draw whose eight rounds all miss (probability below 1e-10 for
    a >= 1) keeps d = a - 1/3. The JAX function's second, per-round fallback
    replaces a value only where it is not positive, which d and every accepted
    d v never are, so it is left out."""
    device = generator.device
    a = torch.as_tensor(a, device=device)
    if not a.dtype.is_floating_point:
        a = a.to(torch.float32)
    needs_boost = a < 1.0
    a_eff = torch.where(needs_boost, a + 1.0, a)
    d = a_eff - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)

    def uniform() -> torch.Tensor:
        return torch.rand(a.shape, generator=generator, device=device, dtype=a.dtype) + 1e-37

    value, accepted = d, torch.zeros(a.shape, dtype=torch.bool, device=device)
    for _ in range(N_ROUNDS):
        x = torch.randn(a.shape, generator=generator, device=device, dtype=a.dtype)
        t = 1.0 + c * x
        v = t * (t * t)
        u = uniform()
        ok = (v > 0.0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(torch.where(v > 0.0, v, 1.0)))
        value = torch.where(ok & ~accepted, d * v, value)
        accepted = accepted | ok
    u_boost = uniform()
    value = torch.where(needs_boost, value * u_boost ** (1.0 / torch.where(needs_boost, a, 1.0)), value)
    if rate is not None:
        value = value / rate
    return value
